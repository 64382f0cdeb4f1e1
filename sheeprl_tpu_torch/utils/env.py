"""Env factory and vector env of the port (counterpart of sheeprl_tpu/utils/env.py
for the dummy envs)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.wrappers import ActionRepeat, ImageTransformWrapper, RecordEpisodeStatistics, TimeLimit

_PORTED_ENV_TARGETS = ("sheeprl_tpu_torch.utils.env.get_dummy_env",)


def get_dummy_env(id: str, **kwargs) -> spaces.Env:
    from sheeprl_tpu_torch.envs import dummy

    if "continuous" in id:
        return dummy.ContinuousDummyEnv(**kwargs)
    if "multidiscrete" in id:
        return dummy.MultiDiscreteDummyEnv(**kwargs)
    if "discrete" in id:
        return dummy.DiscreteDummyEnv(**kwargs)
    raise ValueError(f"Unrecognized dummy environment: {id}")


def make_env(cfg: Dict[str, Any], seed: int, rank: int = 0, vector_env_idx: int = 0) -> Callable[[], spaces.Env]:
    """A thunk building one wrapped env instance, observations as a dict."""

    def thunk() -> spaces.Env:
        from sheeprl_tpu_torch.config import instantiate

        target = str(cfg.env.wrapper.get("_target_", ""))
        if "minedojo" in target.lower():
            raise NotImplementedError(f"env wrapper {target!r} needs the minedojo package, which is not installed: "
                                      "the port builds no MineDojo env")
        if target not in _PORTED_ENV_TARGETS:
            raise NotImplementedError(
                f"env wrapper {target!r} is not ported: the port's env layer runs the dummy envs (env=dummy)"
            )
        if cfg.env.frame_stack > 1 or cfg.env.actions_as_observation.num_stack > 0 or cfg.env.reward_as_observation:
            raise NotImplementedError("frame stacking and actions/rewards as observations are not ported")
        env = instantiate(dict(cfg.env.wrapper))
        if cfg.env.action_repeat > 1:
            env = ActionRepeat(env, cfg.env.action_repeat)
        cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
        if len(cnn_keys + mlp_keys) == 0:
            raise ValueError("`algo.cnn_keys.encoder` and `algo.mlp_keys.encoder` must not both be empty")
        if not isinstance(env.observation_space, spaces.Dict):
            raise NotImplementedError("the port's env layer expects dict observations")
        missing = set(cnn_keys + mlp_keys) - set(env.observation_space.keys())
        if missing:
            raise ValueError(f"keys {sorted(missing)} are not observations of {cfg.env.id}")
        pixel_keys = sorted(k for k in cnn_keys if len(env.observation_space[k].shape) in (2, 3))
        if pixel_keys:
            env = ImageTransformWrapper(env, pixel_keys, cfg.env.screen_size, cfg.env.grayscale)
        env.action_space.seed(seed)
        env.observation_space.seed(seed)
        if cfg.env.max_episode_steps and cfg.env.max_episode_steps > 0:
            env = TimeLimit(env, cfg.env.max_episode_steps)
        return RecordEpisodeStatistics(env)

    return thunk


class SyncVectorEnv:
    """Steps ``n`` envs in this process with same-step autoreset: an env that
    ends is reset at once, its final observation is ``info["final_obs"][i]`` and
    its episode statistics are in ``info["episodes"]``."""

    def __init__(self, env_fns: List[Callable[[], spaces.Env]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        self.action_space = spaces.batch_space(self.single_action_space, self.num_envs)

    def _stack(self, obs_list):
        return {k: np.stack([o[k] for o in obs_list]) for k in obs_list[0]}

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self.action_space.seed(seed)
        obs = [env.reset(seed=None if seed is None else seed + i)[0] for i, env in enumerate(self.envs)]
        return self._stack(obs), {}

    def step(self, actions):
        obs, rewards, terminated, truncated = [], [], [], []
        final_obs: Dict[int, Dict[str, np.ndarray]] = {}
        episodes: List[Tuple[int, float, int]] = []
        for i, (env, action) in enumerate(zip(self.envs, actions)):
            o, r, term, trunc, info = env.step(action)
            if term or trunc:
                final_obs[i] = o
                if "episode" in info:
                    episodes.append((i, float(info["episode"]["r"]), int(info["episode"]["l"])))
                o, _ = env.reset()
            obs.append(o)
            rewards.append(r)
            terminated.append(term)
            truncated.append(trunc)
        info = {"final_obs": final_obs, "episodes": episodes}
        return (self._stack(obs), np.asarray(rewards, dtype=np.float64), np.asarray(terminated, dtype=bool),
                np.asarray(truncated, dtype=bool), info)

    def close(self) -> None:
        for env in self.envs:
            env.close()


def vectorized_env(env_fns: List[Callable[[], spaces.Env]]) -> SyncVectorEnv:
    """The port's vector env. The asynchronous (subprocess) vector env of the
    JAX package is not ported: every ``env.sync_env`` setting steps in-process."""
    return SyncVectorEnv(env_fns)
