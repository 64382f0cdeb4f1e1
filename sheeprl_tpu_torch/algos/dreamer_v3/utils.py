"""DreamerV3 utilities (counterpart of sheeprl_tpu/algos/dreamer_v3/utils.py):
the return-normalizing Moments, TD(lambda) returns, observation preparation and
the test episode."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


class Moments:
    """EMA of the 5th/95th return percentiles, for advantage normalization."""

    def __init__(self, decay: float = 0.99, max_: float = 1e8, percentile_low: float = 0.05,
                 percentile_high: float = 0.95, device=None):
        self.decay, self.max, self.low_q, self.high_q = decay, max_, percentile_low, percentile_high
        self.low = torch.zeros((), device=device)
        self.high = torch.zeros((), device=device)

    def update(self, x: torch.Tensor):
        """Fold in ``x``; returns ``(offset, invscale)``."""
        x = x.detach().float()
        q = torch.quantile(x.reshape(-1), torch.tensor([self.low_q, self.high_q], device=x.device))
        self.low = self.decay * self.low + (1 - self.decay) * q[0]
        self.high = self.decay * self.high + (1 - self.decay) * q[1]
        invscale = torch.clamp_min(self.high - self.low, 1.0 / self.max)
        return self.low, invscale


def compute_lambda_values(rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor,
                          lmbda: float = 0.95) -> torch.Tensor:
    """TD(lambda) returns over the horizon; inputs and output ``[H, B, 1]``."""
    interm = rewards + continues * values * (1 - lmbda)
    out = []
    val = values[-1]
    for t in reversed(range(rewards.shape[0])):
        val = interm[t] + continues[t] * lmbda * val
        out.append(val)
    return torch.stack(out[::-1])


def prepare_obs(obs: Dict[str, np.ndarray], device, cnn_keys: Sequence[str] = (), num_envs: int = 1) -> Dict[str, torch.Tensor]:
    """Host observations -> float tensors ``[1, num_envs, ...]`` on ``device``;
    pixels scaled to ``[-0.5, 0.5]``."""
    out = {}
    for k, v in obs.items():
        t = torch.as_tensor(np.asarray(v), device=device).float()
        if k in cnn_keys:
            out[k] = t.reshape(1, num_envs, -1, *t.shape[-2:]) / 255.0 - 0.5
        else:
            out[k] = t.reshape(1, num_envs, -1)
    return out


@torch.no_grad()
def test(player, runtime, cfg, generator: torch.Generator, greedy: bool = True) -> float:
    """Play one episode on a fresh env; returns and prints its reward."""
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0)()
    obs = env.reset(seed=cfg.seed)[0]
    player.num_envs = 1
    player.init_states()
    done, cumulative = False, 0.0
    keys = player.obs_keys(obs)
    while not done:
        torch_obs = prepare_obs({k: obs[k] for k in keys}, runtime.device, cnn_keys=cfg.algo.cnn_keys.encoder)
        actions = player.get_actions(torch_obs, generator, greedy=greedy)
        if player.actor.is_continuous:
            real = torch.cat(actions, dim=-1).cpu().numpy()
        else:
            real = np.stack([a.argmax(dim=-1).cpu().numpy() for a in actions], axis=-1)
        obs, reward, terminated, truncated, _ = env.step(real.reshape(env.action_space.shape))
        done = bool(terminated) or bool(truncated) or bool(cfg.dry_run)
        cumulative += float(reward)
    print("Test - Reward:", cumulative)
    env.close()
    return cumulative
