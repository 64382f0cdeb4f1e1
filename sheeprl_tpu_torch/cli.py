"""Training CLI of the port: compose the config, build the runtime, run the
algorithm (counterpart of sheeprl_tpu/cli.py's train command).

    python -m sheeprl_tpu_torch exp=dreamer_v3 env=dummy [key=value ...]
    python -m sheeprl_tpu_torch exp=dreamer_v3 env=dummy checkpoint.resume_from=<log_dir>/checkpoint/ckpt_<step>_0.ckpt
"""

from __future__ import annotations

import importlib
import os
import sys
from typing import Any, Optional, Sequence

import torch

from sheeprl_tpu_torch.config import ConfigError, compose, instantiate
from sheeprl_tpu_torch.config.loader import load_yaml
from sheeprl_tpu_torch.utils.registry import algorithm_registry
from sheeprl_tpu_torch.utils.utils import dotdict

#: algorithm packages of the port, imported by name when selected
PORTED_ALGOS = ("dreamer_v3",)


def _port_names(node: Any) -> Any:
    """A JAX sidecar names its classes under ``sheeprl_tpu.``; the port's
    modules of the same path live under ``sheeprl_tpu_torch.``."""
    if isinstance(node, dict):
        return {k: _port_names(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_port_names(v) for v in node]
    if isinstance(node, str) and node.startswith("sheeprl_tpu."):
        return "sheeprl_tpu_torch." + node[len("sheeprl_tpu."):]
    return node


def _get_nested(cfg: Any, dotted: str) -> Any:
    node = cfg
    for part in dotted.split("."):
        node = node[part]
    return node


def _set_nested(cfg: Any, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for part in parts[:-1]:
        node = node[part]
    node[parts[-1]] = value


def resume_from_checkpoint(cfg: dotdict) -> dotdict:
    """Merge the checkpoint's config sidecar (``<ckpt>/../../config.yaml``,
    written by either package) into ``cfg``: the run keeps the sidecar's
    config, and takes ``checkpoint``, ``run_name``, ``root_dir``, ``seed``,
    ``fabric`` and the keys of ``checkpoint.resume_preserve`` from the new
    invocation (counterpart of ``sheeprl_tpu.cli.resume_from_checkpoint``)."""
    if not cfg.checkpoint.resume_from:
        return cfg
    ckpt_path = os.path.abspath(str(cfg.checkpoint.resume_from))
    if not os.path.exists(ckpt_path):
        raise ValueError(f"The checkpoint to resume from does not exist: {ckpt_path}")
    old_cfg_path = os.path.join(os.path.dirname(ckpt_path), os.pardir, "config.yaml")
    if not os.path.isfile(old_cfg_path):
        raise RuntimeError(f"The config file of the checkpoint to resume from does not exist: {old_cfg_path}")
    old_cfg = dotdict(_port_names(load_yaml(old_cfg_path)))
    if old_cfg.env.id != cfg.env.id:
        raise ValueError(
            "This experiment is run with a different environment from the one of the experiment you want to "
            f"restart. Got '{cfg.env.id}', when '{old_cfg.env.id}' is expected.")
    if old_cfg.algo.name != cfg.algo.name:
        raise ValueError(
            "This experiment is run with a different algorithm from the one of the experiment you want to "
            f"restart. Got '{cfg.algo.name}', when '{old_cfg.algo.name}' is expected.")
    merged = dotdict(old_cfg)
    merged.checkpoint = cfg.checkpoint
    merged.checkpoint.resume_from = ckpt_path
    merged.run_name = cfg.run_name
    merged.root_dir = cfg.root_dir
    merged.seed = cfg.seed
    merged.fabric = cfg.fabric
    for key in cfg.checkpoint.get("resume_preserve") or []:
        _set_nested(merged, str(key), _get_nested(cfg, str(key)))
    return merged


def run(overrides: Sequence[str]) -> Any:
    """Compose the config from ``overrides`` (merged with the checkpoint's
    sidecar when ``checkpoint.resume_from`` is set) and run its algorithm;
    returns what the algorithm's entry point returns."""
    cfg = resume_from_checkpoint(compose(overrides))
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
