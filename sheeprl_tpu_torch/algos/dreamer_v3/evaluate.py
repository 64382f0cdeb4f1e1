"""DreamerV3 evaluation (counterpart of sheeprl_tpu/algos/dreamer_v3/evaluate.py):
the player built from a checkpoint's world model and actor plays one test
episode, greedy."""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Mapping

from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _actions_dim
from sheeprl_tpu_torch.algos.dreamer_v3.utils import test
from sheeprl_tpu_torch.compat import flax_params
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.utils.checkpoint import tree_crc32
from sheeprl_tpu_torch.utils.env import make_env
from sheeprl_tpu_torch.utils.registry import register_evaluation


def evaluate_player(runtime, cfg, state: Mapping[str, Any], build_agent_fn: Callable,
                    actor_roots: Mapping[str, flax_params.Path]) -> Dict[str, Any]:
    """Build the agent, copy the checkpoint's ``world_model`` and ``actor``
    into it (every leaf checked before any is copied) and play one greedy test
    episode on a fresh env. Returns the reward, the seconds to build and load
    and to play, the CRC32 of the player's parameters in the checkpoint's
    layout (:func:`tree_crc32`, equal to the file's trees' when the load is
    exact) and the player."""
    t0 = time.perf_counter()
    env = make_env(cfg, cfg.seed, 0)()
    observation_space, action_space = env.observation_space, env.action_space
    env.close()
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    world_model, actor, _, _, player = build_agent_fn(runtime, _actions_dim(action_space),
                                                      isinstance(action_space, spaces.Box), cfg, observation_space)
    loaders = [flax_params.module_loader(world_model, state["world_model"], flax_params.WORLD_MODEL_ROOTS,
                                         "world_model"),
               flax_params.module_loader(actor, state["actor"], actor_roots, "actor")]
    for apply in loaders:
        apply()
    runtime.synchronize()
    load_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    reward = test(player, runtime, cfg, runtime.generator(cfg.seed))
    runtime.synchronize()
    play_seconds = time.perf_counter() - t0
    crc = tree_crc32({"world_model": flax_params.to_flax(dict(world_model.named_parameters()),
                                                         flax_params.WORLD_MODEL_ROOTS),
                      "actor": flax_params.to_flax(dict(actor.named_parameters()), actor_roots)})
    return {"reward": reward, "load_seconds": load_seconds, "play_seconds": play_seconds, "params_crc32": crc,
            "player": player}


@register_evaluation(algorithms="dreamer_v3")
def evaluate(runtime, cfg, state: Mapping[str, Any]) -> Dict[str, Any]:
    return evaluate_player(runtime, cfg, state, build_agent, flax_params.MODULE_ROOTS)
