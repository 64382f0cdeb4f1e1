"""Small helpers shared by the port (counterparts in sheeprl_tpu/utils/utils.py
and sheeprl_tpu/utils/logger.py): the config container, symlog/symexp, the
replay-ratio scheduler, the Polyak update, the versioned run directory and its
config sidecar."""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Iterable, Mapping, Optional

import torch


class dotdict(dict):
    """Nested dict with attribute access (``cfg.algo.world_model.kernels``)."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    @staticmethod
    def _wrap(value):
        if isinstance(value, dotdict):
            return value
        if isinstance(value, Mapping):
            return dotdict(value)
        if isinstance(value, list):
            return [dotdict._wrap(v) for v in value]
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, dotdict._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def as_dict(self) -> Dict[str, Any]:
        return {k: v.as_dict() if isinstance(v, dotdict) else v for k, v in self.items()}


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


@torch.no_grad()
def polyak_update(params: Iterable[torch.Tensor], target_params: Iterable[torch.Tensor], tau: float) -> None:
    """In place: ``target = tau * online + (1 - tau) * target``."""
    for p, tp in zip(params, target_params):
        tp.mul_(1.0 - tau).add_(p, alpha=tau)


class Ratio:
    """Replay-ratio scheduler: gradient steps to run for the policy steps taken
    (counterpart of ``sheeprl_tpu.utils.utils.Ratio``)."""

    def __init__(self, ratio: float, pretrain_steps: int = 0):
        if pretrain_steps < 0:
            raise ValueError(f"'pretrain_steps' must be non-negative, got {pretrain_steps}")
        if ratio < 0:
            raise ValueError(f"'ratio' must be non-negative, got {ratio}")
        self._pretrain_steps = pretrain_steps
        self._ratio = ratio
        self._prev: Optional[float] = None

    def __call__(self, step: int) -> int:
        if self._ratio == 0:
            return 0
        if self._prev is None:
            self._prev = step
            repeats = int(step * self._ratio)
            if self._pretrain_steps > 0:
                if step < self._pretrain_steps:
                    warnings.warn(
                        "The number of pretrain steps is greater than the number of current steps. This could lead "
                        f"to a higher ratio than the one specified ({self._ratio}). Setting the 'pretrain_steps' "
                        "equal to the number of current steps."
                    )
                    self._pretrain_steps = step
                repeats = int(self._pretrain_steps * self._ratio)
            return repeats
        repeats = int((step - self._prev) * self._ratio)
        self._prev += repeats / self._ratio
        return repeats

    def state_dict(self) -> Dict[str, Any]:
        return {"_ratio": self._ratio, "_prev": self._prev, "_pretrain_steps": self._pretrain_steps}

    def load_state_dict(self, state: Mapping[str, Any]) -> "Ratio":
        self._ratio = state["_ratio"]
        self._prev = state["_prev"]
        self._pretrain_steps = state["_pretrain_steps"]
        return self


def _next_version(base: str) -> int:
    versions = []
    for d in os.listdir(base) if os.path.isdir(base) else ():
        if d.startswith("version_"):
            try:
                versions.append(int(d.split("_", 1)[1]))
            except ValueError:
                pass
    return max(versions) + 1 if versions else 0


def get_log_dir(root_dir: str, run_name: str) -> str:
    """A new versioned run directory ``logs/runs/<root_dir>/<run_name>/version_N``
    (counterpart of ``get_log_dir``), created."""
    base = os.path.join("logs", "runs", str(root_dir), str(run_name))
    log_dir = os.path.join(base, f"version_{_next_version(base)}")
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def save_configs(cfg: Mapping[str, Any], log_dir: str) -> None:
    """Write the resolved config to ``<log_dir>/config.yaml``, the sidecar a
    resume reads (``<ckpt>/../../config.yaml``)."""
    from sheeprl_tpu_torch.config.loader import dump_yaml

    os.makedirs(log_dir, exist_ok=True)
    plain = cfg.as_dict() if isinstance(cfg, dotdict) else dict(cfg)
    with open(os.path.join(log_dir, "config.yaml"), "w", encoding="utf-8") as f:
        f.write(dump_yaml(plain))
