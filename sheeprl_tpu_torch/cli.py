"""Training CLI of the port: compose the config, build the runtime, run the
algorithm (counterpart of sheeprl_tpu/cli.py's train command).

    python -m sheeprl_tpu_torch exp=dreamer_v3 env=dummy [key=value ...]
"""

from __future__ import annotations

import importlib
import sys
from typing import Any, Optional, Sequence

import torch

from sheeprl_tpu_torch.config import ConfigError, compose, instantiate
from sheeprl_tpu_torch.utils.registry import algorithm_registry

#: algorithm packages of the port, imported by name when selected
PORTED_ALGOS = ("dreamer_v3",)


def run(overrides: Sequence[str]) -> Any:
    """Compose the config from ``overrides`` and run its algorithm; returns
    what the algorithm's entry point returns."""
    cfg = compose(overrides)
    name = str(cfg.algo.name)
    if name not in PORTED_ALGOS:
        raise ConfigError(f"algo {name!r} is not ported yet (ported: {list(PORTED_ALGOS)})")
    importlib.import_module(f"sheeprl_tpu_torch.algos.{name}.{name}")
    entry = algorithm_registry[name]
    torch.set_num_threads(int(cfg.num_threads))
    torch.set_float32_matmul_precision(str(cfg.float32_matmul_precision))
    runtime = instantiate(cfg.fabric)
    fn = getattr(importlib.import_module(entry["module"]), entry["entrypoint"])
    return fn(runtime, cfg)


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(list(sys.argv[1:] if argv is None else argv))
    return 0
