"""The port's PonderNet actor against the JAX package's
(``sheeprl_tpu/algos/dream_and_ponder/ponder_actor.py``), on the CPU.

- ``compute_halting_distribution``, ``geometric_prior`` and ``ponder_loss`` on
  the same numpy-seeded inputs, over N in {1, 2, 3, 4} and several lambdas;
- the flax ``PonderActor``'s parameters converted with
  ``compat/flax_params.ponder_actor_roots`` into the port's module and back,
  leaf for leaf;
- ``ponder_train`` and ``ponder_infer`` (drawn and ``deterministic_inference``,
  with the default halting threshold and a low one that makes the threshold
  halt instances) on those weights: the port's halting draws are fed the
  uniform fields the JAX ``bernoulli(fold_in(key, n), p)`` compares against,
  and the halted steps must be equal exactly;
- the port's own init follows the JAX init: the same leaves, zero biases,
  ``no_goal_yet`` in ``[0, 1)``, the heads inside their uniform bound;
- one ``PlayerDAP`` step, greedy and sampled, against the JAX
  ``PlayerDAP._raw_step`` at the widths of ``tests/test_torch_dream_and_ponder.py``,
  fed the posterior's Gumbel field, the halting uniforms and the action noise
  the JAX step draws from its key: equal one-hot actions and posteriors (up to
  the straight-through term's rounding, atol 1e-6), recurrent state rtol 1e-4
  / atol 1e-5.

Float32: rtol 1e-4 / atol 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dream_and_ponder import ponder_actor as jpa
from sheeprl_tpu_torch.algos.dream_and_ponder import ponder_actor as tpa
from sheeprl_tpu_torch.compat import flax_params
from tests.test_torch_dream_and_ponder import Draws, action_draws, jax_side, port_trainer

LATENT, DENSE, LAYERS, BATCH = 12, 8, 2, 64
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("lam", [0.05, 0.3, 0.6, 0.95])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_halting_prior_and_loss_match_jax(n, lam):
    rng = np.random.default_rng(10 * n + int(100 * lam))
    halt = rng.uniform(0.0, 1.0, (5, 7, n)).astype(np.float32)
    halt[0, 0] = 1.0  # a certain halt at the first step leaves nothing after it
    got = tpa.compute_halting_distribution(torch.tensor(halt)).numpy()
    np.testing.assert_allclose(got, np.asarray(jpa.compute_halting_distribution(jnp.asarray(halt))), **TOL)
    np.testing.assert_allclose(got.sum(axis=-1), 1.0, rtol=1e-5)

    prior = tpa.geometric_prior(n, lam)
    np.testing.assert_array_equal(prior, jpa.geometric_prior(n, lam))
    assert prior.dtype == np.float32 and abs(float(prior.sum()) - 1.0) < 1e-5

    losses = rng.standard_normal((35, n)).astype(np.float32)
    dist = got.reshape(35, n)
    for beta in (0.01, 0.5):
        ours = tpa.ponder_loss(torch.tensor(losses), torch.tensor(dist), torch.tensor(prior), beta)
        theirs = jpa.ponder_loss(jnp.asarray(losses), jnp.asarray(dist), jnp.asarray(prior), beta)
        np.testing.assert_allclose(float(ours), float(theirs), **TOL)


def test_geometric_prior_refuses_lambda_out_of_range():
    for lam in (0.0, 0.001, 1.0):
        with pytest.raises(ValueError, match="lambda_prior_geom"):
            tpa.geometric_prior(3, lam)


def _kwargs(continuous, deterministic, threshold):
    return dict(actions_dim=(3,) if continuous else (2, 3), is_continuous=continuous, dense_units=DENSE,
                mlp_layers=LAYERS, max_ponder_steps=3, cum_halt_prob_threshold=threshold,
                deterministic_inference=deterministic)


def _pair(continuous=False, deterministic=False, threshold=0.9, seed=0):
    """The flax actor with its parameters moved off their init, and the port's
    actor holding the same weights."""
    kw = _kwargs(continuous, deterministic, threshold)
    jactor = jpa.PonderActor(latent_state_size=LATENT, **kw)
    params = jactor.init(jax.random.PRNGKey(seed), jnp.zeros((1, LATENT)))
    rng = np.random.default_rng(seed)
    host = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.3 * rng.standard_normal(np.shape(x)).astype(np.float32),
                                  jax.device_get(params))
    tactor = tpa.PonderActor(LATENT, **kw)
    roots = flax_params.ponder_actor_roots(LAYERS)
    tactor.load_state_dict(flax_params.to_state_dict(host, roots), strict=True)
    return jactor, jax.tree_util.tree_map(jnp.asarray, host), tactor, roots, host


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("mlp_layers", [1, 2, 5])
def test_flax_tree_maps_to_the_port_and_back(mlp_layers):
    kw = dict(_kwargs(False, False, 0.9), mlp_layers=mlp_layers)
    params = jax.device_get(jpa.PonderActor(latent_state_size=LATENT, **kw).init(
        jax.random.PRNGKey(1), jnp.zeros((1, LATENT))))
    tactor = tpa.PonderActor(LATENT, **kw)
    roots = flax_params.ponder_actor_roots(mlp_layers)
    tactor.load_state_dict(flax_params.to_state_dict(params, roots), strict=True)
    hidden = {"goal_ponder_module": math.ceil(0.8 * mlp_layers), "halt_module": math.ceil(0.4 * mlp_layers),
              "action_decoder": math.ceil(0.4 * mlp_layers)}
    for name, n in hidden.items():
        assert len(getattr(tactor, name).linears) == n
    back, ref = _leaves(flax_params.to_flax(dict(tactor.named_parameters()), roots)), _leaves(params)
    assert set(back) == set(ref)
    for path, x in ref.items():
        np.testing.assert_array_equal(back[path], x, err_msg=path)
    # a load checks every leaf first: a tree of another depth is refused, naming the leaf
    other = jax.device_get(jpa.PonderActor(latent_state_size=LATENT, **dict(kw, mlp_layers=mlp_layers + 1)).init(
        jax.random.PRNGKey(1), jnp.zeros((1, LATENT))))
    with pytest.raises(ValueError, match="actor"):
        flax_params.module_loader(tactor, other, roots, "actor")


@pytest.mark.parametrize("continuous", [False, True])
def test_ponder_train_matches_flax(continuous):
    jactor, params, tactor, _, _ = _pair(continuous=continuous)
    state = np.random.default_rng(2).standard_normal((4, 5, LATENT)).astype(np.float32)
    j_pre, j_halt, j_dist = jactor.apply(params, jnp.asarray(state), method=jpa.PonderActor.ponder_train)
    t_pre, t_halt, t_dist = tactor.ponder_train(torch.tensor(state))
    assert len(t_pre) == len(j_pre)
    for got, ref in zip(t_pre, j_pre):
        assert tuple(got.shape) == ref.shape == (4, 5, 3, ref.shape[-1])
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(t_halt.detach().numpy(), np.asarray(j_halt), **TOL)
    np.testing.assert_allclose(t_dist.detach().numpy(), np.asarray(j_dist), **TOL)


def _halting_fields(key, n_steps, shape):
    return [np.asarray(jax.random.uniform(jax.random.fold_in(key, step), shape, jnp.float32))
            for step in range(n_steps)]


class _Uniforms:
    """The JAX halting draws' uniform fields, handed out in order."""

    def __init__(self, fields):
        self.fields = list(fields)

    def __call__(self, shape, generator, device):
        field = self.fields.pop(0)
        assert field.shape == tuple(shape), (field.shape, tuple(shape))
        return torch.tensor(field, device=device)


@pytest.mark.parametrize("threshold", [0.9, 0.5])
@pytest.mark.parametrize("deterministic", [False, True])
def test_ponder_infer_halts_where_flax_halts(deterministic, threshold, monkeypatch):
    jactor, params, tactor, _, _ = _pair(deterministic=deterministic, threshold=threshold, seed=3)
    state = np.random.default_rng(4).standard_normal((BATCH, LATENT)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    j_pre, j_steps = jactor.apply(params, jnp.asarray(state), key, method=jpa.PonderActor.ponder_infer)
    uniforms = _Uniforms([] if deterministic else _halting_fields(key, 3, (BATCH,)))
    monkeypatch.setattr(tpa, "uniform", uniforms)
    t_pre, t_steps = tactor.ponder_infer(torch.tensor(state), torch.Generator())
    assert not uniforms.fields, "the port drew another number of halting fields than the JAX module"
    np.testing.assert_array_equal(t_steps.numpy(), np.asarray(j_steps))
    assert len(set(t_steps.tolist())) > 1, "every instance halted at the same step: the test shows nothing"
    for got, ref in zip(t_pre, j_pre):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_port_init_follows_the_jax_init():
    kw = _kwargs(False, False, 0.9)
    ref = _leaves(jax.device_get(jpa.PonderActor(latent_state_size=LATENT, **kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, LATENT)))))
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import hafner_init_

    tactor = tpa.PonderActor(LATENT, **kw)
    gen = torch.Generator().manual_seed(0)
    hafner_init_(tactor, gen, {h: 1.0 for h in tactor.heads})
    got = _leaves(flax_params.to_flax(dict(tactor.named_parameters()), flax_params.ponder_actor_roots(LAYERS)))
    assert {p: x.shape for p, x in got.items()} == {p: x.shape for p, x in ref.items()}
    for path, x in got.items():
        if path.endswith("['bias']") and "LayerNorm" not in path:
            assert not x.any() and not ref[path].any(), path
    goal = got["['params']['no_goal_yet']"]
    assert goal.min() >= 0.0 and goal.max() < 1.0
    for i, n in enumerate((2, 3)):
        w = got[f"['params']['head_{i}']['kernel']"]
        assert np.abs(w).max() <= math.sqrt(3.0 / ((DENSE + n) / 2)) + 1e-6


@pytest.fixture(scope="module")
def player_side():
    return jax_side(False, train=False)


@pytest.mark.parametrize("greedy", [False, True])
def test_player_step_matches_jax(player_side, greedy):
    j = player_side
    _, player = port_trainer(j)
    n_envs = 4
    rng = np.random.default_rng(7)
    wm = j.jcfg.algo.world_model
    s, d, R = int(wm.stochastic_size), int(wm.discrete_size), int(wm.recurrent_model.recurrent_state_size)
    state = (np.tanh(rng.standard_normal((1, n_envs, R))).astype(np.float32),
             np.eye(d, dtype=np.float32)[rng.integers(0, d, (1, n_envs, s))].reshape(1, n_envs, s * d),
             np.eye(2, dtype=np.float32)[rng.integers(0, 2, (1, n_envs))])
    obs = {"rgb": (rng.integers(0, 256, (1, n_envs, 3, 16, 16)) / 255.0 - 0.5).astype(np.float32),
           "state": rng.standard_normal((1, n_envs, 10)).astype(np.float32)}
    key = jax.random.PRNGKey(9)
    params = jax.tree_util.tree_map(jnp.asarray, j.host)
    j_acts, j_state = j.jplayer._raw_step(params["world_model"], params["actor"], tuple(map(jnp.asarray, state)),
                                          {k: jnp.asarray(v) for k, v in obs.items()}, key, greedy=greedy)
    k_rep, k_act = jax.random.split(key)
    k_halt, k_sample = jax.random.split(k_act)
    draws = [("gumbel", jax.random.gumbel(k_rep, (1, n_envs, s, d), jnp.float32))]
    draws += [("uniform", jax.random.uniform(jax.random.fold_in(k_halt, i), (1, n_envs), jnp.float32))
              for i in range(int(j.jcfg.algo.ponder.max_ponder_steps))]
    if not greedy:
        draws += action_draws(k_sample, (1, n_envs), False)
    draws = Draws(draws)
    with pytest.MonkeyPatch.context() as mp:
        draws.patch(mp)
        player.num_envs = n_envs
        player.state = tuple(torch.tensor(x) for x in state)
        t_acts = player.get_actions({k: torch.tensor(v) for k, v in obs.items()}, torch.Generator(), greedy)
    assert not draws.draws
    # one-hots up to the rounding of the straight-through term (hard + probs - probs)
    np.testing.assert_allclose(t_acts[0].numpy(), np.asarray(j_acts[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(player.state[0].numpy(), np.asarray(j_state[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(player.state[1].numpy(), np.asarray(j_state[1]), rtol=0, atol=1e-6)
