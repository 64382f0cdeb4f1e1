"""Device, precision and seeding for the port (counterpart of
sheeprl_tpu/core/runtime.py for one process on one device).

- ``accelerator``: ``auto`` resolves to ``cuda``; without a CUDA device it
  raises unless the caller asked for ``cpu``.
- ``precision``: ``32-true``, or ``bf16-mixed``: float32 parameters and
  bfloat16 compute through ``torch.autocast``.
- randomness: explicit ``torch.Generator`` objects made by :meth:`generator`;
  nothing seeds the global generators.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_PRECISIONS = {"32-true": torch.float32, "bf16-mixed": torch.bfloat16}


class Runtime:
    def __init__(self, accelerator: str = "auto", devices: int = 1, precision: str = "32-true"):
        accelerator = str(accelerator).lower()
        if accelerator in ("auto", "cuda", "gpu"):
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"fabric.accelerator={accelerator} needs a CUDA device and none is available; "
                    "pass fabric.accelerator=cpu to run on the CPU"
                )
            self.device = torch.device("cuda", torch.cuda.current_device())
        elif accelerator == "cpu":
            self.device = torch.device("cpu")
        else:
            raise ValueError(f"fabric.accelerator must be auto, cuda, gpu or cpu, got {accelerator!r}")
        if int(devices) != 1:
            raise NotImplementedError(
                f"fabric.devices={devices}: the port runs on one device; multi-GPU training is a later slice"
            )
        if precision not in _PRECISIONS:
            raise ValueError(f"fabric.precision must be one of {sorted(_PRECISIONS)}, got {precision!r}")
        self.precision = precision
        self.compute_dtype = _PRECISIONS[precision]
        self.world_size = 1
        self.global_rank = 0
        self.is_global_zero = True

    def autocast(self):
        """Mixed-precision region: bfloat16 compute under ``bf16-mixed``."""
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device_type=self.device.type, dtype=self.compute_dtype)

    def generator(self, seed: int, device: Optional[torch.device] = None) -> torch.Generator:
        """A fresh generator on ``device`` (default: the run's device) seeded with ``seed``."""
        return torch.Generator(device=device or self.device).manual_seed(int(seed))

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
