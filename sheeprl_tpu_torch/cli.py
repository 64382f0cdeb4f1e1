"""Training and evaluation CLI of the port (counterpart of sheeprl_tpu/cli.py's
train and evaluation commands).

    python -m sheeprl_tpu_torch exp=dreamer_v3 env=dummy [key=value ...]
    python -m sheeprl_tpu_torch exp=dream_and_ponder env=dummy [key=value ...]
    python -m sheeprl_tpu_torch exp=dreamer_v3 env=dummy checkpoint.resume_from=<log_dir>/checkpoint/ckpt_<step>_0.ckpt
    python -m sheeprl_tpu_torch.eval checkpoint_path=<ckpt> [fabric.accelerator=cpu] [seed=...] [prefer_certified=False]
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import warnings
from typing import Any, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.config import ConfigError, compose, instantiate
from sheeprl_tpu_torch.config.loader import load_yaml, parse_scalar
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.utils.registry import algorithm_registry, evaluation_registry
from sheeprl_tpu_torch.utils.utils import dotdict

#: algorithm packages of the port, imported by name when selected
PORTED_ALGOS = ("dreamer_v3", "dream_and_ponder")


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


# --------------------------------------------------------------------------- #
# evaluation
# --------------------------------------------------------------------------- #


def check_configs_evaluation(cfg: dotdict) -> None:
    if cfg.float32_matmul_precision not in ("highest", "high", "medium"):
        raise ValueError(f"Invalid value '{cfg.float32_matmul_precision}' for the 'float32_matmul_precision' "
                         "parameter: the port takes highest, high or medium")
    if cfg.checkpoint_path is None:
        raise ValueError("You must specify the evaluation checkpoint path")


def eval_algorithm(cfg: dotdict) -> Dict[str, Any]:
    """Run the evaluation registered for ``cfg.algo.name`` on the checkpoint
    ``cfg.checkpoint_path``, on one device; returns what it returns."""
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    name = str(cfg.algo.name)
    if name not in PORTED_ALGOS:
        raise ConfigError(f"algo {name!r} is not ported yet (ported: {list(PORTED_ALGOS)})")
    importlib.import_module(f"sheeprl_tpu_torch.algos.{name}.evaluate")
    entry = evaluation_registry.get(name)
    if entry is None:
        raise RuntimeError(f"No evaluation has been registered for the algorithm named '{name}'")
    cfg.algo.run_test = True
    torch.set_num_threads(int(cfg.get("num_threads", 1)))
    torch.set_float32_matmul_precision(str(cfg.float32_matmul_precision))
    runtime = Runtime(accelerator=cfg.fabric.get("accelerator", "auto"), devices=1, precision=cfg.fabric.precision)
    state = load_state(cfg.checkpoint_path)
    return getattr(importlib.import_module(entry["module"]), entry["entrypoint"])(runtime, cfg, state)


def evaluation(overrides: Sequence[str]) -> Dict[str, Any]:
    """The eval command: boot from the checkpoint's ``config.yaml`` sidecar
    (written by either package), evaluate on one env and one device, and
    print one JSON line with the reward, the seconds to load and to play, the
    device and the CRC32 of the evaluated parameters. An uncertified
    ``checkpoint_path`` gives way to the newest certified sibling unless
    ``prefer_certified=False``. Returns the evaluation's summary."""
    from sheeprl_tpu_torch.utils.checkpoint import is_certified, latest_certified

    cli_cfg: Dict[str, Any] = {}
    for ov in overrides:
        key, sep, value = ov.partition("=")
        if not sep:
            raise ConfigError(f"eval arguments are key=value, got {ov!r}")
        cli_cfg[key.strip()] = parse_scalar(value)
    unknown = set(cli_cfg) - {"checkpoint_path", "prefer_certified", "env.capture_video", "fabric.accelerator",
                              "seed", "float32_matmul_precision"}
    if unknown:
        raise ConfigError(f"eval takes no argument {sorted(unknown)}")
    if cli_cfg.get("checkpoint_path") is None:
        raise ConfigError("You must specify checkpoint_path=<path> for evaluation")
    ckpt_path = os.path.abspath(str(cli_cfg["checkpoint_path"]))
    if cli_cfg.get("prefer_certified", True) and not is_certified(ckpt_path):
        certified = latest_certified(os.path.dirname(ckpt_path))
        if certified is not None and os.path.abspath(certified) != ckpt_path:
            warnings.warn(f"checkpoint_path '{ckpt_path}' is not certified; evaluating the certified sibling "
                          f"'{certified}' instead (pass prefer_certified=False to override)")
            ckpt_path = os.path.abspath(certified)
    cfg_path = os.path.join(os.path.dirname(ckpt_path), os.pardir, "config.yaml")
    if not os.path.isfile(cfg_path):
        raise RuntimeError(f"The config file of the checkpoint does not exist: {cfg_path}")
    cfg = dotdict(_port_names(load_yaml(cfg_path)))
    cfg.checkpoint_path = ckpt_path
    cfg.env.num_envs = 1
    cfg.fabric.devices = 1
    cfg.env.capture_video = bool(cli_cfg.get("env.capture_video", cfg.env.get("capture_video", True)))
    for key in ("fabric.accelerator", "seed", "float32_matmul_precision"):
        if key in cli_cfg:
            _set_nested(cfg, key, cli_cfg[key])
    check_configs_evaluation(cfg)
    summary = eval_algorithm(cfg)
    print(json.dumps({"eval": str(cfg.algo.name), "checkpoint": ckpt_path, "device": str(summary["player"].runtime.device),
                      "reward": summary["reward"], "load_seconds": summary["load_seconds"],
                      "play_seconds": summary["play_seconds"], "params_crc32": summary["params_crc32"]}), flush=True)
    return summary


def eval_main(argv: Optional[Sequence[str]] = None) -> int:
    evaluation(list(sys.argv[1:] if argv is None else argv))
    return 0
