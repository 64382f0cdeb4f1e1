"""The port's entry point, config tree, env and buffer layers on the CPU.

- ``python -m sheeprl_tpu_torch ... dry_run=True fabric.accelerator=cpu`` runs
  at tiny widths, also with ``jax``, ``flax`` and ``sheeprl_tpu`` blocked from
  being imported;
- ``fabric.accelerator`` left at ``auto`` raises without a CUDA device;
- no ``_target_`` in the port's config tree names the JAX package, its YAML
  reader agrees with PyYAML on every file, and the composed DreamerV3 config
  carries the JAX package's values;
- the dummy env and the sequential replay buffer give what the JAX package's do.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from sheeprl_tpu.config.loader import _yaml_load
from sheeprl_tpu.config import compose as jcompose
from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JEnvIndependent
from sheeprl_tpu.data.buffers import SequentialReplayBuffer as JSequential
from sheeprl_tpu.envs.dummy import DiscreteDummyEnv as JDiscreteDummy
from sheeprl_tpu_torch.config import compose as tcompose, parse_yaml
from sheeprl_tpu_torch.config.loader import CONFIG_DIR
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.envs.dummy import DiscreteDummyEnv
from sheeprl_tpu_torch.utils.env import make_env, vectorized_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_RUN = [
    "exp=dreamer_v3", "env=dummy", "dry_run=True", "fabric.accelerator=cpu", "algo.per_rank_batch_size=1",
    "algo.per_rank_sequence_length=1", "buffer.size=4", "algo.learning_starts=0", "algo.horizon=4",
    "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.discrete_size=4", "algo.world_model.stochastic_size=4", "algo.mlp_keys.encoder=[state]",
    "buffer.memmap=False", "env.num_envs=1",
]


def _run(code_or_args, tmp_path, module=False):
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "sheeprl_tpu_torch", *code_or_args] if module else [sys.executable, "-c", code_or_args]
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("kernels", ["off", "auto"])
def test_cli_dry_run_on_cpu(tmp_path, kernels):
    out = _run(TINY_RUN + [f"algo.world_model.kernels={kernels}"], tmp_path, module=True)
    assert "gradient_steps=1" in out and "Test - Reward" in out


def test_cli_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu"):
            sys.modules[name] = None  # any import of these now raises ImportError
        from sheeprl_tpu_torch import cli
        summary = cli.run({TINY_RUN + ["algo.world_model.kernels=auto"]!r})
        assert summary["gradient_steps"] == 1, summary
        leaked = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in ("jax", "flax", "sheeprl_tpu")]
        assert not leaked, leaked
        print("PORT_OK")
    """)
    assert "PORT_OK" in _run(code, tmp_path)


def test_accelerator_auto_raises_without_cuda(tmp_path, monkeypatch):
    import torch

    from sheeprl_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    args = [a for a in TINY_RUN if not a.startswith("fabric.accelerator")]
    with pytest.raises(RuntimeError, match="fabric.accelerator=cpu"):
        cli.run(args)


def _yaml_files():
    for base, _, files in os.walk(CONFIG_DIR):
        for f in sorted(files):
            if f.endswith(".yaml"):
                yield os.path.join(base, f)


def _targets(node):
    if isinstance(node, dict):
        for k, v in node.items():
            if k in ("_target_", "cls"):
                yield str(v)
            yield from _targets(v)
    elif isinstance(node, list):
        for v in node:
            yield from _targets(v)


def test_config_tree_names_no_jax_target_and_parses_like_pyyaml():
    files = list(_yaml_files())
    assert len(files) >= 10
    targets = []
    for path in files:
        with open(path) as f:
            text = f.read()
        ours = parse_yaml(text)
        assert ours == _yaml_load(text), path
        targets += list(_targets(ours))
    assert targets and all(not t.startswith("sheeprl_tpu.") for t in targets), targets
    assert any(t.startswith("sheeprl_tpu_torch.") for t in targets)


def _flatten(node, prefix=""):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: node}


def test_composed_config_carries_the_jax_values():
    overrides = ["exp=dreamer_v3", "env=dummy", "algo.world_model.kernels=auto", "seed=3"]
    ours = _flatten(tcompose(overrides).as_dict())
    theirs = _flatten(dict(jcompose("config", overrides).as_dict()))
    skip = ("run_name",)
    for key, value in ours.items():
        if key in skip:
            continue
        assert key in theirs, key
        expected = theirs[key]
        if isinstance(expected, str):
            expected = expected.replace("sheeprl_tpu.", "sheeprl_tpu_torch.")
        assert value == expected, (key, value, expected)
    assert ours["algo.world_model.kernels"] == "auto" and ours["fabric.precision"] == "bf16-mixed"
    assert ours["algo.per_rank_batch_size"] == 16 and ours["algo.per_rank_sequence_length"] == 64
    assert ours["algo.horizon"] == 15 and ours["env.id"] == "discrete_dummy"


def test_dummy_env_and_vector_env_follow_the_jax_env():
    ours, theirs = DiscreteDummyEnv(), JDiscreteDummy()
    o1, o2 = ours.reset()[0], theirs.reset()[0]
    for _ in range(6):
        for k in o1:
            np.testing.assert_array_equal(o1[k], o2[k])
        s1, s2 = ours.step(0), theirs.step(0)
        assert s1[1:4] == s2[1:4]
        o1, o2 = s1[0], s2[0]
    cfg = tcompose(TINY_RUN)
    envs = vectorized_env([make_env(cfg, 0, vector_env_idx=i) for i in range(2)])
    obs, _ = envs.reset(seed=0)
    assert obs["rgb"].shape == (2, 3, 64, 64) and obs["rgb"].dtype == np.uint8
    ended = 0
    for _ in range(6):
        obs, _, term, trunc, info = envs.step(np.zeros(2, dtype=np.int64))
        ended += len(info["episodes"])
        for i in info["final_obs"]:
            assert int(obs["rgb"][i].max()) == 0  # autoreset: the returned obs starts the next episode
    assert ended == 2


def test_sequential_buffer_samples_like_the_jax_buffer():
    rng = np.random.default_rng(0)
    data = {"obs": rng.standard_normal((40, 3, 5)).astype(np.float32),
            "is_first": (rng.random((40, 3, 1)) < 0.1).astype(np.float32)}
    for cls, jcls, kwargs in ((SequentialReplayBuffer, JSequential, dict(n_envs=3)),
                              (EnvIndependentReplayBuffer, JEnvIndependent, dict(n_envs=3, buffer_cls=SequentialReplayBuffer))):
        ours = cls(16, **kwargs)
        jkwargs = dict(kwargs, buffer_cls=JSequential) if "buffer_cls" in kwargs else kwargs
        theirs = jcls(16, obs_keys=("obs",), **jkwargs)
        for start in range(0, 40, 8):
            chunk = {k: v[start:start + 8] for k, v in data.items()}
            ours.add(chunk)
            theirs.add(chunk)
        ours.seed(7)
        theirs.seed(7)
        a = ours.sample(4, n_samples=2, sequence_length=5)
        b = theirs.sample(4, n_samples=2, sequence_length=5)
        for k in data:
            assert a[k].shape == (2, 5, 4, *data[k].shape[2:])
            np.testing.assert_array_equal(a[k], b[k])
