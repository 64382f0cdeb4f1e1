"""The port's eval command (``python -m sheeprl_tpu_torch.eval``, counterpart
of ``sheeprl_eval.py``) on the CPU, on checkpoints of both packages.

- A Dream-and-Ponder run of the port's CLI (one dry-run iteration at tiny
  widths, ``checkpoint.save_last=True``) in a subprocess where ``jax``,
  ``flax``, ``optax`` and ``sheeprl_tpu`` cannot be imported: one gradient
  step, 14 finite metrics, ``State/expected_ponder_steps`` within [1, N].
- ``evaluation`` on a JAX DreamerV3 checkpoint, a JAX Dream-and-Ponder
  checkpoint (``DAPOptStates`` pickled) and the port's Dream-and-Ponder
  checkpoint: the player's world model and actor equal the file's trees
  bitwise, and the printed ``params_crc32`` equals the CRC of those trees.
- The certified sibling: an uncertified ``checkpoint_path`` gives way to the
  newest sibling certified by the JAX package's ``certify``, unless
  ``prefer_certified=False``.
- The module entry in a subprocess with ``jax``, ``flax``, ``optax``,
  ``sheeprl_tpu`` and ``yaml`` blocked, on the JAX DreamerV3 checkpoint.
"""

import glob
import json
import os
import shutil
import textwrap

import jax
import numpy as np
import pytest

from sheeprl_tpu.algos.dream_and_ponder import agent as jdap_agent
from sheeprl_tpu.algos.dream_and_ponder.dream_and_ponder import DAPOptStates, make_train_fn
from sheeprl_tpu.algos.dreamer_v3.utils import init_moments
from sheeprl_tpu.config import compose as jcompose
from sheeprl_tpu.core.runtime import Runtime as JRuntime
from sheeprl_tpu.utils import checkpoint as jckpt
from sheeprl_tpu.utils.utils import save_configs as jsave_configs
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.compat import flax_params
from sheeprl_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_checkpoint import BLOCKED, TINY_TRAIN, _jax_state, _tiny_obs_space
from tests.test_torch_cli import _run
from tests.test_torch_dream_and_ponder import DAP_TINY

#: DAP_TINY at 64 x 64 (the dummy env's size), one dry-run iteration, a checkpoint at its end
DAP_RUN = [a for a in DAP_TINY if a != "env.screen_size=16"] + [
    "dry_run=True", "fabric.accelerator=cpu", "algo.per_rank_batch_size=1", "algo.per_rank_sequence_length=1",
    "buffer.size=4", "algo.learning_starts=0", "buffer.memmap=False", "env.num_envs=1",
    "algo.world_model.kernels=auto", "checkpoint.save_last=True", "run_name=port_dap",
]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Checkpoints of both packages with their config sidecars, by source."""
    root = tmp_path_factory.mktemp("eval")
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu"):
            sys.modules[name] = None  # any import of these now raises ImportError
        from sheeprl_tpu_torch import cli
        summary = cli.run({DAP_RUN!r})
        assert summary["gradient_steps"] == 1, summary
        (row,) = summary["losses"]
        assert len(row) == 14 and all(v == v and abs(v) != float("inf") for v in row.values()), row
        assert 1.0 <= row["State/expected_ponder_steps"] <= 2.0, row
        assert type(summary["live"]["trainer"]).__name__ == "DAPTrainer"
        leaked = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in ("jax", "flax", "sheeprl_tpu")]
        assert not leaked, leaked
        print("PORT_OK")
    """)
    out = {"port_run_stdout": _run(code, root)}
    (port,) = glob.glob(str(root / "logs" / "runs" / "**" / "port_dap" / "version_0" / "checkpoint" / "*.ckpt"),
                        recursive=True)
    out["port_dap"] = port

    jcfg, state = _jax_state(TINY_TRAIN, _tiny_obs_space())
    out["jax_dv3"] = _save_jax(root / "jax_dv3", jcfg, state)

    jcfg = jcompose("config", [a for a in DAP_RUN if not a.startswith(("fabric.", "run_name"))])
    jruntime = JRuntime(accelerator="cpu", devices=1, precision="32-true")
    modules, params, _ = jdap_agent.build_agent(jruntime, (2,), False, jcfg, _tiny_obs_space())
    init_opt, _ = make_train_fn(modules, jcfg, jruntime, False, (2,))
    state = {**{k: jax.device_get(params[k]) for k in ("world_model", "actor", "critic", "target_critic")},
             "opt_states": jax.device_get(init_opt(params)), "moments": tuple(np.asarray(v) for v in init_moments()),
             "counter": 0, "ratio": {"_ratio": 1.0, "_prev": 1.0, "_pretrain_steps": 0}, "iter_num": 1,
             "batch_size": 1, "last_log": 0, "last_checkpoint": 1,
             "rng": np.asarray(jax.device_get(jax.random.PRNGKey(0)))}
    assert isinstance(state["opt_states"], DAPOptStates)
    out["jax_dap"] = _save_jax(root / "jax_dap", jcfg, state)
    return out


def _save_jax(run_dir, jcfg, state):
    log_dir = run_dir / "version_0"
    jsave_configs(jcfg, str(log_dir))
    path = str(log_dir / "checkpoint" / "ckpt_1_0.ckpt")
    jckpt.save_state(path, state)
    return path


def _player_trees(player, algo, mlp_layers):
    roots = flax_params.ponder_actor_roots(mlp_layers) if algo == "dream_and_ponder" else flax_params.MODULE_ROOTS
    return {"world_model": flax_params.to_flax(dict(player.world_model.named_parameters()),
                                               flax_params.WORLD_MODEL_ROOTS),
            "actor": flax_params.to_flax(dict(player.actor.named_parameters()), roots)}


def _last_json(text):
    return json.loads([line for line in text.splitlines() if line.startswith("{")][-1])


def test_cli_dap_run_with_jax_and_the_jax_package_blocked(ckpts):
    assert "PORT_OK" in ckpts["port_run_stdout"] and "Test - Reward" in ckpts["port_run_stdout"]
    state = tckpt.load_state(ckpts["port_dap"], fallback_to_older=False)
    assert state["counter"] == 1 and set(state["opt_states"]) == {"world", "actor", "critic"}


@pytest.mark.parametrize("source,algo", [("jax_dv3", "dreamer_v3"), ("jax_dap", "dream_and_ponder"),
                                         ("port_dap", "dream_and_ponder")])
def test_eval_loads_the_checkpoint_bitwise(ckpts, source, algo, capsys):
    path = ckpts[source]
    summary = cli.evaluation([f"checkpoint_path={path}", "fabric.accelerator=cpu", "seed=5"])
    printed = _last_json(capsys.readouterr().out)
    player = summary["player"]
    assert printed["eval"] == algo and printed["device"] == "cpu" and printed["checkpoint"] == os.path.abspath(path)
    assert np.isfinite(printed["reward"]) and printed["reward"] == summary["reward"]
    assert type(player).__name__ == ("PlayerDAP" if algo == "dream_and_ponder" else "PlayerDV3")
    state = tckpt.load_state(path, fallback_to_older=False)
    ours = _player_trees(player, algo, 1)
    theirs = {k: state[k] for k in ("world_model", "actor")}
    assert tckpt.assert_same_tree(ours, theirs, "the player's parameters") > 0
    assert printed["params_crc32"] == summary["params_crc32"] == tckpt.tree_crc32(theirs)


def test_eval_prefers_the_certified_sibling(ckpts, tmp_path, capsys):
    src = os.path.dirname(os.path.dirname(ckpts["port_dap"]))
    run = tmp_path / "run" / "version_0"
    os.makedirs(run / "checkpoint")
    shutil.copy(os.path.join(src, "config.yaml"), run / "config.yaml")
    older, newer = str(run / "checkpoint" / "ckpt_1_0.ckpt"), str(run / "checkpoint" / "ckpt_2_0.ckpt")
    state = tckpt.load_state(ckpts["port_dap"], fallback_to_older=False)
    info = tckpt.save_state(older, state)
    jckpt.certify(older, crc32=info["crc32"], size=info["size"])
    moved = dict(state, actor=jax.tree_util.tree_map(lambda x: x + np.float32(1.0), state["actor"]))
    tckpt.save_state(newer, moved)
    os.utime(older, (1_000_000_000, 1_000_000_000))
    assert tckpt.is_certified(older) and not tckpt.is_certified(newer)
    assert tckpt.latest_certified(str(run / "checkpoint")) == older

    with pytest.warns(UserWarning, match="certified sibling"):
        cli.evaluation([f"checkpoint_path={newer}", "fabric.accelerator=cpu"])
    printed = _last_json(capsys.readouterr().out)
    assert printed["checkpoint"] == older
    assert printed["params_crc32"] == tckpt.tree_crc32({k: state[k] for k in ("world_model", "actor")})

    cli.evaluation([f"checkpoint_path={newer}", "fabric.accelerator=cpu", "prefer_certified=False"])
    printed = _last_json(capsys.readouterr().out)
    assert printed["checkpoint"] == newer
    assert printed["params_crc32"] == tckpt.tree_crc32({k: moved[k] for k in ("world_model", "actor")})


def test_eval_refuses_unknown_arguments_and_a_missing_sidecar(ckpts, tmp_path):
    with pytest.raises(cli.ConfigError, match="checkpoint_path"):
        cli.evaluation(["fabric.accelerator=cpu"])
    with pytest.raises(cli.ConfigError, match="algo.total_steps"):
        cli.evaluation([f"checkpoint_path={ckpts['jax_dv3']}", "algo.total_steps=3"])
    lone = tmp_path / "a" / "b" / "ckpt_1_0.ckpt"
    os.makedirs(lone.parent)
    shutil.copy(ckpts["jax_dv3"], lone)
    with pytest.raises(RuntimeError, match="config file"):
        cli.evaluation([f"checkpoint_path={lone}", "fabric.accelerator=cpu"])


def test_eval_module_runs_with_jax_blocked(ckpts, tmp_path):
    code = textwrap.dedent(f"""
        import runpy, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None  # any import of these now raises ImportError
        sys.argv = ["sheeprl_tpu_torch.eval", "checkpoint_path={ckpts['jax_dv3']}", "fabric.accelerator=cpu"]
        try:
            runpy.run_module("sheeprl_tpu_torch.eval", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        leaked = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in ("jax", "flax", "sheeprl_tpu")]
        assert not leaked, leaked
    """)
    printed = _last_json(_run(code, tmp_path))
    state = tckpt.load_state(ckpts["jax_dv3"], fallback_to_older=False)
    assert printed["eval"] == "dreamer_v3" and printed["device"] == "cpu"
    assert printed["params_crc32"] == tckpt.tree_crc32({k: state[k] for k in ("world_model", "actor")})
