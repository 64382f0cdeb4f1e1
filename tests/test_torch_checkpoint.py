"""The port's checkpoint container and config sidecar against the JAX package's,
on the CPU.

- the port's ``_manifest`` equals the JAX package's for the same trees
  (nested dicts, tuples, lists, ``DV3OptStates`` holding optax states);
- the JAX package's ``load_state`` reads a file the port wrote;
- the port reads a file the JAX package wrote, and resumes from it through its
  CLI, in a subprocess where ``jax``, ``jaxlib``, ``flax``, ``optax``,
  ``sheeprl_tpu`` and ``yaml`` cannot be imported;
- a truncated or bit-flipped newest file falls back to its older sibling, as
  the JAX package's does; a pickled class the port does not map raises
  ``CheckpointClassError`` and never falls back; ``keep_last`` keeps the
  newest files;
- ``dump_yaml`` -> ``yaml.safe_load`` and ``yaml.safe_dump`` -> the port's
  reader give back a composed DreamerV3 config.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import warnings

import gymnasium as gym
import jax
import numpy as np
import pytest
import yaml

from sheeprl_tpu.algos.dreamer_v3 import agent as jagent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_fn
from sheeprl_tpu.algos.dreamer_v3.utils import init_moments
from sheeprl_tpu.config import compose as jcompose
from sheeprl_tpu.core.runtime import Runtime as JRuntime
from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JEnvIndependent
from sheeprl_tpu.data.buffers import SequentialReplayBuffer as JSequential
from sheeprl_tpu.utils import checkpoint as jckpt
from sheeprl_tpu.utils.utils import save_configs as jsave_configs
from sheeprl_tpu_torch.config import compose as tcompose, parse_yaml
from sheeprl_tpu_torch.config.loader import ConfigError, dump_yaml
from sheeprl_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_cli import REPO, TINY_RUN

BLOCKED = ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu", "yaml")
#: TINY_RUN trained for 4 policy steps instead of one dry-run step
TINY_TRAIN = [a for a in TINY_RUN if a != "dry_run=True"] + ["algo.total_steps=4", "algo.run_test=False",
                                                            "metric.log_level=0"]


def _jax_state(overrides, obs_space, iter_num=2):
    """A JAX DreamerV3 checkpoint state with the keys of its ``_save_checkpoint``
    and its replay buffer's ``state_dict``."""
    jcfg = jcompose("config", overrides)
    jruntime = JRuntime(accelerator="cpu", devices=1, precision="32-true")
    modules, params, _ = jagent.build_agent(jruntime, (2,), False, jcfg, obs_space)
    init_opt, _ = make_train_fn(modules, jcfg, jruntime, False, (2,))
    rng = np.random.default_rng(0)
    rb = JEnvIndependent(int(jcfg.buffer.size), n_envs=1, obs_keys=tuple(obs_space.spaces), buffer_cls=JSequential)
    rb.add({"rgb": rng.integers(0, 256, (iter_num, 1) + obs_space["rgb"].shape, dtype=np.uint8),
            "state": rng.standard_normal((iter_num, 1) + obs_space["state"].shape).astype(np.float32),
            "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (iter_num, 1))],
            "rewards": rng.standard_normal((iter_num, 1, 1)), "truncated": np.zeros((iter_num, 1, 1)),
            "terminated": np.zeros((iter_num, 1, 1)), "is_first": np.zeros((iter_num, 1, 1))})
    state = {
        **{k: jax.device_get(params[k]) for k in ("world_model", "actor", "critic", "target_critic")},
        "opt_states": jax.device_get(init_opt(params)),
        "moments": tuple(np.asarray(v) for v in init_moments()),
        "counter": 0,
        "ratio": {"_ratio": 1.0, "_prev": float(iter_num), "_pretrain_steps": 0},
        "iter_num": iter_num,
        "batch_size": int(jcfg.algo.per_rank_batch_size),
        "last_log": 0,
        "last_checkpoint": iter_num,
        "rng": np.asarray(jax.device_get(jax.random.PRNGKey(0))),
        "rb": rb.state_dict(),
    }
    return jcfg, state


def _tiny_obs_space(screen=64):
    return gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, screen, screen), np.uint8),
                            "state": gym.spaces.Box(-20, 20, (10,), np.float32)})


@pytest.fixture(scope="module")
def jax_state():
    return _jax_state(TINY_TRAIN, _tiny_obs_space())


def test_manifest_equals_jax_manifest(jax_state):
    _, state = jax_state
    trees = [
        state,
        {"a": {"b": (np.zeros(3), [np.ones((2, 2), np.int32), {"c": np.zeros((), np.float32)}])}, "d": 1, "e": None},
        (np.zeros(1), {"z": np.zeros(2), "a": np.zeros(3)}),
    ]
    for tree in trees:
        ours = tckpt._manifest(tree)
        assert ours == jckpt._manifest(tree)
        assert ours
    assert "['opt_states'].world[1][0].mu['encoder']['params']['cnn_encoder']['CNN_0']['Conv_0']['kernel']" in \
        tckpt._manifest(state)


def test_jax_load_state_reads_a_port_file(tmp_path, monkeypatch):
    import torch

    from sheeprl_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    summary = cli.run(TINY_TRAIN + ["checkpoint.every=2"])
    live = summary["live"]
    path = os.path.join(summary["log_dir"], "checkpoint", "ckpt_4_0.ckpt")
    theirs = jckpt.load_state(path, fallback_to_older=False)
    ours = tckpt.load_state(path, fallback_to_older=False)
    tckpt.assert_same_tree(theirs, ours)
    assert jckpt.read_manifest(path) == tckpt.read_manifest(path) == jckpt._manifest(theirs)
    assert set(theirs) == {"world_model", "actor", "critic", "target_critic", "opt_states", "moments", "counter",
                           "ratio", "iter_num", "batch_size", "last_log", "last_checkpoint", "rng", "rb"}
    assert theirs["counter"] == live["trainer"].counter == 4 and theirs["iter_num"] == 4
    assert int(theirs["opt_states"]["world"][1][0]["count"]) == 4
    assert torch.equal(torch.from_numpy(theirs["rng"]["torch"]), live["generator"].get_state())


def test_port_reads_and_resumes_a_jax_file_with_jax_blocked(tmp_path, jax_state):
    jcfg, state = jax_state
    log_dir = tmp_path / "jax_run" / "version_0"
    jsave_configs(jcfg, str(log_dir))
    path = str(log_dir / "checkpoint" / "ckpt_2_0.ckpt")
    jckpt.save_state(path, state)
    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None  # any import of these now raises ImportError
        import numpy as np
        from sheeprl_tpu_torch import cli
        from sheeprl_tpu_torch.utils import checkpoint
        state = checkpoint.load_state({path!r}, fallback_to_older=False)
        assert type(state["opt_states"]).__name__ == "DV3OptStates", type(state["opt_states"])
        assert int(state["opt_states"].world[1][0].count) == 0
        summary = cli.run(["exp=dreamer_v3", "env=dummy", "fabric.accelerator=cpu",
                           "checkpoint.resume_from={path}"])
        # iteration 3 re-anchors the Ratio as the JAX loop does; iteration 4 trains one step
        assert summary["gradient_steps"] == 1, summary["gradient_steps"]
        trainer = summary["live"]["trainer"]
        assert trainer.counter == 1 and all(np.isfinite(list(r.values())).all() for r in summary["losses"])
        leaked = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in {BLOCKED!r}]
        assert not leaked, leaked
        print("PORT_RESUMED_JAX")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "PORT_RESUMED_JAX" in proc.stdout
    assert "seeded from seed=42" in proc.stdout


def _two_files(tmp_path):
    older, newer = str(tmp_path / "ckpt_2_0.ckpt"), str(tmp_path / "ckpt_4_0.ckpt")
    tckpt.save_state(older, {"step": 2, "w": np.arange(6, dtype=np.float32)})
    tckpt.save_state(newer, {"step": 4, "w": np.arange(6, dtype=np.float32) * 2})
    os.utime(older, (1_000_000, 1_000_000))
    return older, newer


@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_damaged_newest_file_falls_back_like_jax(tmp_path, damage):
    older, newer = _two_files(tmp_path)
    with open(newer, "rb") as f:
        data = bytearray(f.read())
    if damage == "truncate":
        data = data[: len(data) - 40]
    else:
        data[len(data) // 2] ^= 0xFF
    with open(newer, "wb") as f:
        f.write(bytes(data))
    for load, error in ((tckpt.load_state, tckpt.CheckpointCorruptionError),
                        (jckpt.load_state, jckpt.CheckpointCorruptionError)):
        with pytest.warns(UserWarning, match="older sibling"):
            assert load(newer)["step"] == 2
        with pytest.raises(error):
            load(newer, fallback_to_older=False)


def test_callback_keeps_the_newest_checkpoints(tmp_path):
    callback = tckpt.CheckpointCallback(keep_last=2)
    for step in (2, 4, 6, 8):
        path = str(tmp_path / f"ckpt_{step}_0.ckpt")
        callback.on_checkpoint_coupled(path, {"step": step})
        os.utime(path, (1_000_000 + step, 1_000_000 + step))
    callback._gc(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["ckpt_6_0.ckpt", "ckpt_8_0.ckpt"]


class Unmapped:
    pass


def test_unknown_pickled_class_raises_without_fallback(tmp_path):
    _, newer = _two_files(tmp_path)
    state = {"step": 4, "thing": Unmapped()}
    with open(newer, "wb") as f:
        pickle.dump({"__format__": tckpt._CKPT_MAGIC, "format_version": 1, "manifest": {}}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)
        writer = tckpt._CrcWriter(f)
        pickle.dump(state, writer, protocol=pickle.HIGHEST_PROTOCOL)
        pickle.dump({"crc32": writer.crc}, f, protocol=pickle.HIGHEST_PROTOCOL)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(tckpt.CheckpointClassError, match="test_torch_checkpoint.Unmapped"):
            tckpt.load_state(newer)


def test_directory_and_sharded_config_raise(tmp_path, monkeypatch):
    from sheeprl_tpu_torch import cli

    os.makedirs(tmp_path / "ckpt_1_0.ckpt")
    with pytest.raises(NotImplementedError, match="sharded"):
        tckpt.load_state(str(tmp_path / "ckpt_1_0.ckpt"))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ConfigError, match="checkpoint.sharded"):
        cli.run(TINY_RUN + ["checkpoint.sharded=True"])
    with pytest.raises(ConfigError, match="checkpoint.peer_replicate_every"):
        cli.run(TINY_RUN + ["checkpoint.peer_replicate_every=3"])


def test_config_sidecar_round_trips_both_ways():
    overrides = ["exp=dreamer_v3", "env=dummy", "algo.world_model.kernels=off"]
    ours = tcompose(overrides).as_dict()
    assert yaml.safe_load(dump_yaml(ours)) == ours
    assert parse_yaml(dump_yaml(ours)) == ours
    theirs = jcompose("config", overrides).as_dict()
    text = yaml.safe_dump(theirs, sort_keys=False)
    assert parse_yaml(text) == yaml.safe_load(text)
    odd = {"on": "off", "eps": 1e-05, "big": 1e20, "none": None, "empty": [], "nothing": {}, "q": "it's \"x\" #1",
           "nested": [{"a": [1, 2.5]}, [3, "b: c"]], "line": "a\nb", "inf": float("inf")}
    assert yaml.safe_load(dump_yaml(odd)) == odd == parse_yaml(dump_yaml(odd))
    del odd["line"]  # PyYAML writes a line break inside a string over a blank line, which the reader refuses
    text = yaml.safe_dump(odd, sort_keys=False, width=20)
    assert parse_yaml(text) == yaml.safe_load(text)
    with pytest.raises(ConfigError, match="blank line"):
        parse_yaml(yaml.safe_dump({"line": "a\nb"}))
