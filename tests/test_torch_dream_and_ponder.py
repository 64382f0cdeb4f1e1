"""Dream-and-Ponder of the port against the JAX package's, on the CPU, at the
widths of ``tests/test_algos/test_algos.py::test_dream_and_ponder`` (dense 8,
one layer, recurrent 8, 4 x 4 stochastic, 5 bins, horizon 4,
``max_ponder_steps=2``) with 16 x 16 pixels, float32.

- Two train steps from the same converted parameters and batches, for the
  discrete and the continuous dummy env: the JAX side runs ``make_train_fn``
  (``sheeprl_tpu/algos/dream_and_ponder/dream_and_ponder.py``) with
  ``kernels=reference``, the port ``DAPTrainer.train_step`` with
  ``kernels=auto`` (on the CPU, the plain versions inside the kernels'
  ``autograd.Function``s), fed the draws the JAX step takes from its keys: the
  posterior Gumbel field, the first actions' noise of every branch, then for
  each imagined step the prior's Gumbel field, one halting uniform field per
  ponder step and the actions' noise. All 14 metrics, the Moments state and
  the target critic after its EMA: rtol 1e-4 / atol 1e-6.
- Checkpoints: a JAX file (``DAPOptStates`` pickled) loads into the port and
  the port's next step equals the JAX next step, every parameter after the
  update included; a port file is read by the JAX ``load_state``, its
  ``DAPOptStates`` rebuilt, and the next steps agree the same way.
- The composed ``exp=dream_and_ponder`` config at the XS, S and XL presets
  against the JAX package's.

The player step is held in ``tests/test_torch_ponder.py``, the CLI run in
``tests/test_torch_eval.py``.
"""

import types

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.dream_and_ponder import agent as jdap_agent
from sheeprl_tpu.algos.dream_and_ponder.dream_and_ponder import DAPOptStates, make_train_fn
from sheeprl_tpu.algos.dreamer_v3.utils import MomentsState, init_moments
from sheeprl_tpu.config import compose as jcompose
from sheeprl_tpu.core.runtime import Runtime as JRuntime
from sheeprl_tpu.utils import checkpoint as jckpt
from sheeprl_tpu_torch.algos.dream_and_ponder import agent as tdap_agent
from sheeprl_tpu_torch.algos.dream_and_ponder import dream_and_ponder as tdap
from sheeprl_tpu_torch.algos.dream_and_ponder import ponder_actor as tpa
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tdv3_agent
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
from sheeprl_tpu_torch.compat import flax_params
from sheeprl_tpu_torch.config import compose as tcompose
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.ops import distributions as tdist
from sheeprl_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_cli import _flatten

DAP_TINY = [
    "exp=dream_and_ponder", "env=dummy", "env.screen_size=16", "algo.horizon=4", "algo.dense_units=8",
    "algo.mlp_layers=1", "algo.ponder.max_ponder_steps=2", "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8", "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4", "algo.world_model.reward_model.bins=5", "algo.critic.bins=5",
    "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
]
T, B, STEPS = 5, 3, 2
TOL = dict(rtol=1e-4, atol=1e-6)


def _batch(rng, continuous):
    actions = (np.tanh(rng.standard_normal((T, B, 2))) if continuous
               else np.eye(2)[rng.integers(0, 2, (T, B))]).astype(np.float32)
    return {
        "rgb": rng.integers(0, 256, (T, B, 3, 16, 16), dtype=np.uint8),
        "state": rng.standard_normal((T, B, 10)).astype(np.float32),
        "actions": actions,
        "rewards": rng.standard_normal((T, B, 1)).astype(np.float32),
        "terminated": (rng.random((T, B, 1)) < 0.1).astype(np.float32),
        "is_first": (rng.random((T, B, 1)) < 0.2).astype(np.float32),
    }


def action_draws(key, batch, continuous):
    if continuous:
        return [("normal", jax.random.normal(key, (*batch, 2), jnp.float32))]
    return [("gumbel", jax.random.gumbel(jax.random.split(key, 1)[0], (*batch, 2), jnp.float32))]


def _step_draws(key, cfg, continuous):
    """The noise one JAX gradient step draws from ``key``, in the port's order."""
    wm = cfg.algo.world_model
    s, d = int(wm.stochastic_size), int(wm.discrete_size)
    n, tb = int(cfg.algo.ponder.max_ponder_steps), T * B
    k_wm, k_img0, k_img, _ = jax.random.split(jax.random.split(key, 1)[0], 4)
    draws = [("gumbel", jax.random.gumbel(jax.random.fold_in(k_wm, 1), (T, B, s, d), jnp.float32))]
    draws += action_draws(k_img0, (tb, n), continuous)
    for k in jax.random.split(k_img, int(cfg.algo.horizon)):
        k_img_step, k_halt, k_act = jax.random.split(k, 3)
        draws.append(("gumbel", jax.random.gumbel(k_img_step, (n * tb, s, d), jnp.float32)))
        draws += [("uniform", jax.random.uniform(jax.random.fold_in(k_halt, i), (n * tb,), jnp.float32))
                  for i in range(n)]
        draws += action_draws(k_act, (n * tb,), continuous)
    return draws


class Draws:
    """Prepared JAX draws handed out in order in place of the port's draws
    from its generators; each must come in the kind and shape expected."""

    def __init__(self, draws):
        self.draws = [(kind, np.array(x, np.float32)) for kind, x in draws]

    def _take(self, kind, shape, device, dtype=torch.float32):
        got_kind, field = self.draws.pop(0)
        assert (got_kind, field.shape) == (kind, tuple(shape)), ((got_kind, field.shape), (kind, tuple(shape)))
        return torch.tensor(field, dtype=dtype, device=device)

    def patch(self, mp):
        def gumbel(shape, generator, device, dtype=torch.float32):
            return self._take("gumbel", shape, device, dtype)

        def normal(shape, generator, device, dtype=torch.float32):
            return self._take("normal", shape, device, dtype)

        for module in (tdv3, tdap, tdist, tdv3_agent):
            mp.setattr(module, "gumbel", gumbel)
        mp.setattr(tdist, "normal", normal)
        mp.setattr(tpa, "uniform", lambda shape, generator, device: self._take("uniform", shape, device))


def obs_spaces():
    jobs = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 16, 16), np.uint8),
                            "state": gym.spaces.Box(-20, 20, (10,), np.float32)})
    tobs = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 16, 16), np.uint8), "state": spaces.Box(-20, 20, (10,))})
    return jobs, tobs


def jax_side(continuous, train=True):
    """The JAX agent at ``DAP_TINY`` with every parameter moved off its init,
    and its train function when ``train``."""
    jcfg = jcompose("config", DAP_TINY + ["algo.world_model.kernels=reference"])
    jruntime = JRuntime(accelerator="cpu", devices=1, precision="32-true")
    modules, params, jplayer = jdap_agent.build_agent(jruntime, (2,), continuous, jcfg, obs_spaces()[0])
    # off the Hafner init, whose zero reward and critic heads leave no advantage to learn from
    noise_rng = np.random.default_rng(3)
    host = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * noise_rng.standard_normal(np.shape(x)).astype(np.float32),
        jax.device_get(params))
    init_opt, train_fn = make_train_fn(modules, jcfg, jruntime, continuous, (2,)) if train else (None, None)
    return types.SimpleNamespace(jcfg=jcfg, host=host, init_opt=init_opt, train_fn=train_fn, jplayer=jplayer,
                                 continuous=continuous)


@pytest.fixture(scope="module")
def sides():
    return {"discrete": jax_side(False), "continuous": jax_side(True)}


def port_trainer(j, load=True):
    tcfg = tcompose(DAP_TINY + ["algo.world_model.kernels=auto", "fabric.accelerator=cpu"])
    runtime = Runtime(accelerator="cpu", precision="32-true")
    wm, actor, critic, target, player = tdap_agent.build_agent(runtime, (2,), j.continuous, tcfg, obs_spaces()[1])
    trainer = tdap.DAPTrainer(wm, actor, critic, target, tcfg, runtime, j.continuous, [2])
    if load:
        for key, module, roots, _, _ in trainer._nets():
            module.load_state_dict(flax_params.to_state_dict(j.host[key], roots), strict=True)
    return trainer, player


def _jax_step(j, carry, data, key):
    params, opt_states, moments, counter = carry
    params, opt_states, moments, counter, _, metrics = j.train_fn(
        params, opt_states, moments, counter, {k: jnp.asarray(v[None]) for k, v in data.items()}, key)
    return (params, opt_states, moments, counter), metrics


def _port_step(j, trainer, data, key):
    draws = Draws(_step_draws(key, j.jcfg, j.continuous))
    with pytest.MonkeyPatch.context() as mp:
        draws.patch(mp)
        metrics = trainer.train_step({k: torch.tensor(v) for k, v in data.items()}, torch.Generator())
    assert not draws.draws, "the port drew fewer fields than the JAX step"
    return metrics


def _assert_step_agrees(trainer, t_metrics, carry, j_metrics, what, all_params=False):
    params, _, moments, counter = carry
    assert len(trainer.metric_names) == len(j_metrics) == 14
    for name, got in zip(trainer.metric_names, t_metrics.tolist()):
        np.testing.assert_allclose(got, float(j_metrics[name]), **TOL, err_msg=f"{what}: {name}")
    assert 1.0 <= float(t_metrics[-1]) <= trainer.n_ponder
    np.testing.assert_allclose(float(trainer.moments.low), float(moments.low), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(trainer.moments.high), float(moments.high), rtol=1e-4, atol=1e-7)
    host = jax.device_get(params)
    for key, module, roots, _, _ in trainer._nets():
        if key != "target_critic" and not all_params:
            continue
        ref = flax_params.to_state_dict(host[key], roots)
        got = module.state_dict()
        assert set(ref) == set(got)
        for name, x in ref.items():
            np.testing.assert_allclose(got[name].numpy(), x.numpy(), **TOL, err_msg=f"{what}: {key} {name}")
    assert trainer.counter == int(counter)


@pytest.mark.parametrize("action", ["discrete", "continuous"])
def test_train_steps_match_jax(sides, action):
    j = sides[action]
    trainer, _ = port_trainer(j)
    params = jax.tree_util.tree_map(jnp.asarray, j.host)
    carry = (params, j.init_opt(params), init_moments(), jnp.int32(0))
    rng = np.random.default_rng(4)
    for step in range(STEPS):
        data, key = _batch(rng, j.continuous), jax.random.PRNGKey(100 + step)
        carry, j_metrics = _jax_step(j, carry, data, key)
        t_metrics = _port_step(j, trainer, data, key)
        _assert_step_agrees(trainer, t_metrics, carry, j_metrics, f"{action} step {step}")
    assert trainer.counter == STEPS


def _extras(iter_num):
    return {"ratio": {"_ratio": 1.0, "_prev": float(iter_num), "_pretrain_steps": 0}, "iter_num": iter_num,
            "batch_size": B, "last_log": 0, "last_checkpoint": iter_num}


def test_jax_checkpoint_resumes_in_the_port(sides, tmp_path):
    j = sides["discrete"]
    params = jax.tree_util.tree_map(jnp.asarray, j.host)
    carry = (params, j.init_opt(params), init_moments(), jnp.int32(0))
    rng = np.random.default_rng(5)
    batches = [_batch(rng, False) for _ in range(3)]
    for step in range(2):
        carry, _ = _jax_step(j, carry, batches[step], jax.random.PRNGKey(200 + step))
    params, opt_states, moments, counter = jax.device_get(carry)
    assert isinstance(opt_states, DAPOptStates)
    state = {**{k: params[k] for k in ("world_model", "actor", "critic", "target_critic")},
             "opt_states": opt_states, "moments": tuple(np.asarray(v) for v in moments), "counter": int(counter),
             **_extras(2), "rng": np.asarray(jax.device_get(jax.random.PRNGKey(0)))}
    path = str(tmp_path / "ckpt_2_0.ckpt")
    jckpt.save_state(path, state)
    carry, j_metrics = _jax_step(j, jax.tree_util.tree_map(jnp.asarray, (params, opt_states, moments, counter)),
                                 batches[2], jax.random.PRNGKey(202))

    loaded = tckpt.load_state(path, fallback_to_older=False)
    assert isinstance(loaded["opt_states"], tckpt.DAPOptStates)
    trainer, _ = port_trainer(j, load=False)
    trainer.load_state_dict(loaded)
    assert trainer.counter == 2
    assert float(trainer.actor_opt.optimizer.state[trainer.actor.no_goal_yet]["step"]) == 2.0
    t_metrics = _port_step(j, trainer, batches[2], jax.random.PRNGKey(202))
    _assert_step_agrees(trainer, t_metrics, carry, j_metrics, "JAX -> port, step 3", all_params=True)


def test_port_checkpoint_resumes_in_jax(sides, tmp_path):
    j = sides["discrete"]
    trainer, _ = port_trainer(j)
    rng = np.random.default_rng(6)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        trainer.train_step({k: torch.tensor(v) for k, v in _batch(rng, False).items()}, gen)
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

    opt_states = DAPOptStates(**{k: chain(v) for k, v in state["opt_states"].items()})
    assert jax.tree_util.tree_structure(opt_states) == jax.tree_util.tree_structure(j.init_opt(params))
    carry = (params, opt_states, MomentsState(*[jnp.asarray(v) for v in state["moments"]]), jnp.int32(state["counter"]))
    for step in range(2):
        data, key = _batch(rng, False), jax.random.PRNGKey(300 + step)
        carry, j_metrics = _jax_step(j, carry, data, key)
        t_metrics = _port_step(j, trainer, data, key)
        _assert_step_agrees(trainer, t_metrics, carry, j_metrics, f"port -> JAX, step {3 + step}", all_params=True)


@pytest.mark.parametrize("size", ["XS", "S", "XL"])
def test_composed_config_carries_the_jax_values(size):
    overrides = ["exp=dream_and_ponder", f"algo=dream_and_ponder_{size}", "env=dummy", "algo.world_model.kernels=auto",
                 "seed=3"]
    ours = _flatten(tcompose(overrides).as_dict())
    theirs = _flatten(dict(jcompose("config", overrides).as_dict()))
    for key, value in ours.items():
        if key == "run_name":
            continue
        assert key in theirs, key
        expected = theirs[key]
        if isinstance(expected, str):
            expected = expected.replace("sheeprl_tpu.", "sheeprl_tpu_torch.")
        assert value == expected, (key, value, expected)
    assert ours["fabric.precision"] == "32-true" and ours["algo.name"] == "dream_and_ponder"
    assert ours["algo.ponder.max_ponder_steps"] == 3
    assert ours["algo.dense_units"] == {"XS": 256, "S": 512, "XL": 1024}[size]
    assert ours["algo.per_rank_batch_size"] * ours["algo.per_rank_sequence_length"] == 1024
