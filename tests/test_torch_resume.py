"""Resuming across the two packages on the CPU, at the ``TINY`` config of
``tests/test_torch_dreamer_v3.py`` (float32, ``kernels=reference``), with the
steps built as ``tests/test_torch_behaviour.py`` builds them.

- JAX -> port: two JAX train steps, a checkpoint written by the JAX package's
  ``save_state`` (the keys of its ``_save_checkpoint`` and its buffer's
  ``state_dict``), loaded by the port; the port's next step, fed the JAX
  step's Gumbel fields, against the JAX package's third step.
- port -> JAX: two port steps, a checkpoint written by the port, read by the
  JAX package's ``load_state``; the optax state is rebuilt from the plain
  containers and the next steps agree the same way.
- port -> port, through the CLI at ``TINY_RUN`` widths: the state of a resumed
  run equals, bitwise, the state the first run saved, and a run resumed from
  its middle checkpoint takes the gradient steps of the JAX loop's resume
  schedule;
- one JAX checkpoint resumed by both packages' CLIs: the same gradient steps
  and the same schedule state (counter, iteration, Ratio) at the end.

Metrics, the Moments state, and every parameter after the step (the world
model, actor and critic after their Adam updates, the target critic after its
EMA): rtol 1e-4 (atol 1e-6 on the parameters, 1e-7 on the Moments).
"""

import copy
import glob
import os

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jagent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import DV3OptStates, make_train_fn
from sheeprl_tpu.algos.dreamer_v3.utils import MomentsState, init_moments
from sheeprl_tpu.config import compose as jcompose
from sheeprl_tpu.core.runtime import Runtime as JRuntime
from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JEnvIndependent
from sheeprl_tpu.data.buffers import SequentialReplayBuffer as JSequential
from sheeprl_tpu.utils import checkpoint as jckpt
from sheeprl_tpu.utils.utils import save_configs as jsave_configs
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tagent
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
from sheeprl_tpu_torch.compat import flax_params
from sheeprl_tpu_torch.config import compose as tcompose
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.ops import distributions as tdist
from sheeprl_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_agent_features import _Noise
from tests.test_torch_behaviour import _step_noise
from tests.test_torch_checkpoint import TINY_TRAIN, _jax_state, _tiny_obs_space
from tests.test_torch_dreamer_v3 import TINY, _batch


@pytest.fixture(scope="module")
def setup():
    jcfg = jcompose("config", TINY)
    jobs = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 16, 16), np.uint8),
                            "state": gym.spaces.Box(-20, 20, (10,), np.float32)})
    jruntime = JRuntime(accelerator="cpu", devices=1, precision="32-true")
    modules, params, _ = jagent.build_agent(jruntime, (2,), False, jcfg, jobs)
    # off the Hafner init, whose zero reward and critic heads leave no advantage (see test_torch_behaviour)
    noise_rng = np.random.default_rng(3)
    host = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * noise_rng.standard_normal(np.shape(x)).astype(np.float32),
        jax.device_get(params))
    init_opt, train_fn = make_train_fn(modules, jcfg, jruntime, False, (2,))
    return jcfg, host, init_opt, train_fn


def _port_trainer():
    tcfg = tcompose(TINY + ["fabric.accelerator=cpu"])
    tobs = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 16, 16), np.uint8), "state": spaces.Box(-20, 20, (10,))})
    runtime = Runtime(accelerator="cpu", precision="32-true")
    wm, actor, critic, target, _ = tagent.build_agent(runtime, (2,), False, tcfg, tobs)
    return tdv3.DV3Trainer(wm, actor, critic, target, tcfg, runtime, False, [2])


def _jax_step(train_fn, carry, data, key):
    params, opt_states, moments, counter = carry
    params, opt_states, moments, counter, _, metrics = train_fn(
        params, opt_states, moments, counter, {k: jnp.asarray(v[None]) for k, v in data.items()}, key)
    return (params, opt_states, moments, counter), metrics


def _port_step(trainer, jcfg, data, key, monkeypatch):
    wm_cfg = jcfg.algo.world_model
    noise = _Noise(_step_noise(key, int(jcfg.algo.horizon), int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size), 2))
    monkeypatch.setattr(tdv3, "gumbel", noise)
    monkeypatch.setattr(tdist, "gumbel", noise)
    metrics = trainer.train_step({k: torch.tensor(v) for k, v in data.items()}, torch.Generator())
    assert not noise.fields, "the port drew another number of Gumbel fields than the JAX step"
    return metrics


def _assert_step_agrees(trainer, t_metrics, carry, j_metrics, what):
    params, _, moments, counter = carry
    for name, got in zip(tdv3.METRIC_NAMES, t_metrics.tolist()):
        np.testing.assert_allclose(got, float(j_metrics[name]), rtol=1e-4, err_msg=f"{what}: {name}")
    np.testing.assert_allclose(float(trainer.moments.low), float(moments.low), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(trainer.moments.high), float(moments.high), rtol=1e-4, atol=1e-7)
    host = jax.device_get(params)
    for key, module, roots, _, _ in trainer._nets():
        ref_params = flax_params.to_state_dict(host[key], roots)
        got_params = module.state_dict()
        assert set(ref_params) == set(got_params)
        for name, ref in ref_params.items():
            np.testing.assert_allclose(got_params[name].numpy(), ref.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{what}: {key} {name} after the update")
    assert trainer.counter == int(counter)


def _extras(iter_num):
    return {"ratio": {"_ratio": 1.0, "_prev": float(iter_num), "_pretrain_steps": 0}, "iter_num": iter_num,
            "batch_size": 3, "last_log": 0, "last_checkpoint": iter_num}


def test_jax_checkpoint_resumes_in_the_port(setup, tmp_path, monkeypatch):
    jcfg, host, init_opt, train_fn = setup
    params = jax.tree_util.tree_map(jnp.asarray, host)
    carry = (params, init_opt(params), init_moments(), jnp.int32(0))
    rng = np.random.default_rng(4)
    batches = [_batch(rng) for _ in range(3)]
    for step in range(2):
        carry, _ = _jax_step(train_fn, carry, batches[step], jax.random.PRNGKey(100 + step))
    params, opt_states, moments, counter = jax.device_get(carry)
    rb = JEnvIndependent(8, n_envs=2, obs_keys=("rgb", "state"), buffer_cls=JSequential)
    for data in batches[:2]:
        rb.add({k: v[:, :2] for k, v in data.items()})
    state = {**{k: params[k] for k in ("world_model", "actor", "critic", "target_critic")},
             "opt_states": opt_states, "moments": tuple(np.asarray(v) for v in moments), "counter": int(counter),
             **_extras(2), "rng": np.asarray(jax.device_get(jax.random.PRNGKey(0))), "rb": rb.state_dict()}
    path = str(tmp_path / "ckpt_2_0.ckpt")
    jckpt.save_state(path, state)
    carry, j_metrics = _jax_step(train_fn, jax.tree_util.tree_map(jnp.asarray, (params, opt_states, moments, counter)),
                                 batches[2], jax.random.PRNGKey(102))

    loaded = tckpt.load_state(path, fallback_to_older=False)
    assert isinstance(loaded["opt_states"], tckpt.DV3OptStates)
    trainer = _port_trainer()
    trainer.load_state_dict(loaded)
    assert trainer.counter == 2
    assert float(trainer.world_opt.optimizer.state[trainer.world_model.rssm.initial_recurrent_state]["step"]) == 2.0
    port_rb = EnvIndependentReplayBuffer(8, n_envs=2, buffer_cls=SequentialReplayBuffer)
    port_rb.load_state_dict(loaded["rb"])
    tckpt.assert_same_tree(port_rb.state_dict(), rb.state_dict())
    # the checkpoint callbacks' truncated-flag patch: the port's rule is the JAX buffer's
    jax_undo = [b._patch_truncated() for b in rb.buffer]
    tckpt.assert_same_tree(_as_saved(port_rb), rb.state_dict())
    for b, u in zip(rb.buffer, jax_undo):
        b._unpatch_truncated(u)
    t_metrics = _port_step(trainer, jcfg, batches[2], jax.random.PRNGKey(102), monkeypatch)
    _assert_step_agrees(trainer, t_metrics, carry, j_metrics, "JAX -> port, step 3")


def test_port_checkpoint_resumes_in_jax(setup, tmp_path, monkeypatch):
    jcfg, host, init_opt, train_fn = setup
    trainer = _port_trainer()
    trainer.world_model.load_state_dict(flax_params.world_model_state_dict(host["world_model"]), strict=True)
    trainer.actor.load_state_dict(flax_params.to_state_dict(host["actor"]), strict=True)
    trainer.critic.load_state_dict(flax_params.to_state_dict(host["critic"]), strict=True)
    trainer.target_critic.load_state_dict(flax_params.to_state_dict(host["target_critic"]), strict=True)
    rng = np.random.default_rng(5)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        trainer.train_step({k: torch.tensor(v) for k, v in _batch(rng).items()}, gen)
    path = str(tmp_path / "ckpt_2_0.ckpt")
    tckpt.save_state(path, {**trainer.state_dict(), **_extras(2), "rng": {"torch": gen.get_state().numpy()}})

    state = jckpt.load_state(path, fallback_to_older=False)
    params = {k: jax.tree_util.tree_map(jnp.asarray, state[k])
              for k in ("world_model", "actor", "critic", "target_critic")}

    def chain(plain):  # ((), ({"count", "mu", "nu"}, ())) -> optax.chain(clip_by_global_norm, adam)'s state
        adam = plain[1][0]
        return (optax.EmptyState(), (optax.ScaleByAdamState(
            count=jnp.asarray(adam["count"]), mu=jax.tree_util.tree_map(jnp.asarray, adam["mu"]),
            nu=jax.tree_util.tree_map(jnp.asarray, adam["nu"])), optax.EmptyState()))

    opt_states = DV3OptStates(**{k: chain(v) for k, v in state["opt_states"].items()})
    assert jax.tree_util.tree_structure(opt_states) == jax.tree_util.tree_structure(init_opt(params))
    carry = (params, opt_states, MomentsState(*[jnp.asarray(v) for v in state["moments"]]), jnp.int32(state["counter"]))
    for step in range(2):
        data, key = _batch(rng), jax.random.PRNGKey(200 + step)
        carry, j_metrics = _jax_step(train_fn, carry, data, key)
        t_metrics = _port_step(trainer, jcfg, data, key, monkeypatch)
        _assert_step_agrees(trainer, t_metrics, carry, j_metrics, f"port -> JAX, step {3 + step}")


def _ckpts(log_dir):
    return sorted(glob.glob(os.path.join(log_dir, "checkpoint", "*.ckpt")), key=tckpt.ckpt_step)


def _as_saved(rb):
    """The buffer's state as the checkpoint callback writes it, built with the
    buffer's own truncated-flag patch."""
    undo = rb._patch_truncated()
    state = copy.deepcopy(rb.state_dict())
    rb._unpatch_truncated(undo)
    return state


def test_port_resume_is_bitwise_and_keeps_the_step_count(tmp_path, monkeypatch):
    from sheeprl_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    train = TINY_TRAIN + ["run_name=one_name"]
    run_a = cli.run(train + ["checkpoint.every=2"])
    assert run_a["gradient_steps"] == 4
    middle, last = _ckpts(run_a["log_dir"])
    live = run_a["live"]

    saved = tckpt.load_state(last, fallback_to_older=False)
    tckpt.assert_same_tree({k: saved[k] for k in live["trainer"].state_dict()}, live["trainer"].state_dict())
    tckpt.assert_same_tree(saved["rb"], _as_saved(live["rb"]))
    assert saved["ratio"] == live["ratio"].state_dict()
    assert torch.equal(torch.from_numpy(saved["rng"]["torch"]), live["generator"].get_state())
    assert saved["rng"]["rb"] == live["rb"].rng_states()

    # the save leaves the live buffer's truncated flags as they were
    before = [np.array(b["buffer"]["truncated"]) for b in live["rb"].state_dict()["buffers"]]
    tckpt.CheckpointCallback().on_checkpoint_coupled(str(tmp_path / "again.ckpt"), {}, live["rb"])
    after = [b["buffer"]["truncated"] for b in live["rb"].state_dict()["buffers"]]
    # bitwise, as the storage's unwritten rows hold whatever bits np.empty left there
    assert [x.tobytes() for x in before] == [y.tobytes() for y in after]
    assert [x.tobytes() for x in before] != [y["buffer"]["truncated"].tobytes() for y in saved["rb"]["buffers"]]

    # resumed from its last checkpoint, a run holds exactly the saved state
    run_b = cli.run(train + [f"checkpoint.resume_from={last}"])
    assert run_b["gradient_steps"] == 0
    assert [os.path.basename(r["log_dir"]) for r in (run_a, run_b)] == ["version_0", "version_1"]
    tckpt.assert_same_tree(run_b["live"]["trainer"].state_dict(), live["trainer"].state_dict())
    tckpt.assert_same_tree(run_b["live"]["rb"].state_dict(), saved["rb"])
    assert torch.equal(run_b["live"]["generator"].get_state(), live["generator"].get_state())

    # resumed from the middle (iteration 2), it takes the JAX loop's count: learning_starts and
    # the Ratio's offset move to start_iter=3, so iteration 3 re-anchors the Ratio and trains
    # nothing, and iteration 4 trains one step (test_resume_schedule_matches_the_jax_loop)
    run_c = cli.run(train + [f"checkpoint.resume_from={middle}"])
    assert tckpt.load_state(middle)["counter"] == 2 and run_c["gradient_steps"] == 1
    assert run_c["live"]["trainer"].counter == 3


def test_resume_schedule_matches_the_jax_loop(tmp_path, monkeypatch):
    """One JAX checkpoint, resumed by the JAX package's CLI and by the port's:
    both take the same gradient steps and end in the same schedule state."""
    from sheeprl_tpu import cli as jcli
    from sheeprl_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    # 8 iterations, learning_starts 2: a resume at iteration 2 trains from iteration 5 on
    train = [a for a in TINY_TRAIN if a != "algo.total_steps=4"] + ["algo.total_steps=8", "algo.learning_starts=2",
                                                                   "checkpoint.save_last=True"]
    jcfg, state = _jax_state(train, _tiny_obs_space())
    log_dir = tmp_path / "jax_run" / "version_0"
    jsave_configs(jcfg, str(log_dir))
    path = str(log_dir / "checkpoint" / "ckpt_2_0.ckpt")
    jckpt.save_state(path, state)

    resume = [f"checkpoint.resume_from={path}"]
    port = cli.run(train + resume + ["run_name=port"])
    jcli.run(train + resume + ["run_name=jax"])
    jax_last = glob.glob(os.path.join("logs", "runs", "**", "jax", "version_*", "checkpoint", "ckpt_8_0.ckpt"),
                         recursive=True)
    assert len(jax_last) == 1, jax_last
    theirs = jckpt.load_state(jax_last[0], fallback_to_older=False)
    ours = tckpt.load_state(_ckpts(port["log_dir"])[-1], fallback_to_older=False)
    assert port["gradient_steps"] == 3
    for key in ("counter", "iter_num", "last_checkpoint", "batch_size", "ratio"):
        assert np.asarray(ours[key]).tolist() == np.asarray(theirs[key]).tolist(), key
