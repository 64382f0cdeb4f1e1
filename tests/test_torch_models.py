"""The port's modules, distributions, optimizer and return math against the JAX
package's, on parameters carried across by ``sheeprl_tpu_torch/compat/flax_params.py``.

Both agents are built at a tiny DreamerV3 size from the same overrides; the
flax initialisation is converted into the port's modules with ``strict``
loading (every parameter mapped, none left over). Float32 on the CPU; forward
tolerance rtol 1e-4 / atol 1e-5 unless a test states otherwise.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jagent
from sheeprl_tpu.algos.dreamer_v3 import utils as jutils
from sheeprl_tpu.config import compose as jcompose
from sheeprl_tpu.ops import distributions as jd
from sheeprl_tpu.utils.optim import adam as jadam, with_clipping as jclip
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tagent
from sheeprl_tpu_torch.algos.dreamer_v3 import utils as tutils
from sheeprl_tpu_torch.compat import flax_params
from sheeprl_tpu_torch.config import compose as tcompose
from sheeprl_tpu_torch.core.runtime import Runtime
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.ops import distributions as td
from sheeprl_tpu_torch.utils.optim import adam as tadam, with_clipping as tclip

TINY = [
    "exp=dreamer_v3", "env=dummy", "fabric.precision=32-true", "env.screen_size=16", "algo.dense_units=8",
    "algo.mlp_layers=2", "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.transition_model.hidden_size=8",
    "algo.world_model.representation_model.hidden_size=8", "algo.world_model.stochastic_size=2",
    "algo.world_model.discrete_size=3", "algo.mlp_keys.encoder=[state]", "algo.mlp_keys.decoder=[state]",
]
RTOL, ATOL = 1e-4, 1e-5


class _JaxRuntime:
    compute_dtype = jnp.float32


@pytest.fixture(scope="module")
def agents():
    jcfg, tcfg = jcompose("config", TINY), tcompose(TINY + ["fabric.accelerator=cpu"])
    jobs = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 16, 16), np.uint8),
                            "state": gym.spaces.Box(-20, 20, (10,), np.float32)})
    tobs = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 16, 16), np.uint8),
                        "state": spaces.Box(-20, 20, (10,), np.float32)})
    modules, params, _ = jagent.build_agent(_JaxRuntime(), (2,), False, jcfg, jobs)
    runtime = Runtime(accelerator="cpu", precision="32-true")
    wm, actor, critic, _, _ = tagent.build_agent(runtime, (2,), False, tcfg, tobs)
    np_params = jax.device_get(params)
    wm.load_state_dict(flax_params.world_model_state_dict(np_params["world_model"]), strict=True)
    actor.load_state_dict(flax_params.to_state_dict(np_params["actor"]), strict=True)
    critic.load_state_dict(flax_params.to_state_dict(np_params["critic"]), strict=True)
    return modules, params, wm, actor, critic


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def test_encoder_cnn_and_mlp(agents):
    modules, params, wm, _, _ = agents
    rng = np.random.default_rng(0)
    obs = {"rgb": rng.uniform(-0.5, 0.5, (2, 3, 3, 16, 16)).astype(np.float32),
           "state": rng.standard_normal((2, 3, 10)).astype(np.float32)}
    ref = modules.encoder.apply(params["world_model"]["encoder"], {k: jnp.asarray(v) for k, v in obs.items()})
    _close(wm.encoder({k: torch.tensor(v) for k, v in obs.items()}), ref)


def test_decoder_decnn_and_mlp(agents):
    modules, params, wm, _, _ = agents
    latent = np.random.default_rng(1).standard_normal((2, 3, 14)).astype(np.float32)
    ref = modules.observation_model.apply(params["world_model"]["observation_model"], jnp.asarray(latent))
    got = wm.observation_model(torch.tensor(latent))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k])


def test_recurrent_model_layernorm_gru(agents):
    modules, params, wm, _, _ = agents
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    h = np.tanh(rng.standard_normal((4, 8))).astype(np.float32)
    ref = modules.rssm.recurrent_model.apply(params["world_model"]["recurrent_model"], jnp.asarray(x), jnp.asarray(h))
    _close(wm.rssm.recurrent_model(torch.tensor(x), torch.tensor(h)), ref)


@pytest.mark.parametrize("name", ["transition_model", "representation_model", "reward_model", "continue_model"])
def test_mlp_with_head(agents, name):
    modules, params, wm, _, _ = agents
    jm = getattr(modules.rssm, name, None) or getattr(modules, name)
    tm = getattr(wm.rssm, name, None) or getattr(wm, name)
    x = np.random.default_rng(3).standard_normal((5, tm.mlp.linears[0].in_features)).astype(np.float32)
    _close(tm(torch.tensor(x)), jm.apply(params["world_model"][name], jnp.asarray(x)))


def test_actor_critic_and_initial_states(agents):
    modules, params, wm, actor, critic = agents
    x = np.random.default_rng(4).standard_normal((5, 14)).astype(np.float32)
    for got, ref in zip(actor(torch.tensor(x)), modules.actor.apply(params["actor"], jnp.asarray(x))):
        _close(got, ref)
    _close(critic(torch.tensor(x)), modules.critic.apply(params["critic"], jnp.asarray(x)))
    j_rec, j_post = modules.rssm.initial_states(params["world_model"], (2, 3))
    t_rec, t_post = wm.rssm.initial_states((2, 3))
    _close(t_rec, j_rec)
    np.testing.assert_array_equal(t_post.numpy(), np.asarray(j_post))


def test_parameter_counts_match(agents):
    _, params, wm, actor, critic = agents
    count = lambda tree: sum(np.size(v) for v in jax.tree_util.tree_leaves(tree))  # noqa: E731
    assert sum(p.numel() for p in wm.parameters()) == count(params["world_model"])
    assert sum(p.numel() for p in actor.parameters()) == count(params["actor"])
    assert sum(p.numel() for p in critic.parameters()) == count(params["critic"])


def test_hafner_init_statistics():
    """The port's own init (not converted): trunc-normal fan-avg trunks, zero
    reward/critic heads, unit LayerNorms."""
    tcfg = tcompose(TINY + ["fabric.accelerator=cpu", "algo.dense_units=64"])
    tobs = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 16, 16), np.uint8), "state": spaces.Box(-20, 20, (10,))})
    wm, actor, critic, target, _ = tagent.build_agent(Runtime("cpu"), (2,), False, tcfg, tobs)
    w = wm.rssm.transition_model.mlp.linears[0].weight
    assert abs(float(w.std()) - (2.0 / sum(w.shape)) ** 0.5) < 0.2 * (2.0 / sum(w.shape)) ** 0.5
    assert float(w.abs().max()) <= 2 * (2.0 / sum(w.shape)) ** 0.5 / 0.87962566103423978 + 1e-6
    assert not wm.reward_model.head.weight.any() and not critic.head.weight.any()
    assert bool((wm.rssm.recurrent_model.mlp.norms[0].weight == 1).all())
    for p, tp in zip(critic.parameters(), target.parameters()):
        assert torch.equal(p, tp) and not tp.requires_grad


def test_distributions():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 3, 255)).astype(np.float32)
    x = (rng.standard_normal((4, 3, 1)) * 30).astype(np.float32)
    j2, t2 = jd.TwoHotEncodingDistribution(jnp.asarray(logits), dims=1), td.TwoHotEncodingDistribution(torch.tensor(logits), dims=1)
    _close(t2.log_prob(torch.tensor(x)), j2.log_prob(jnp.asarray(x)))
    _close(t2.mean, j2.mean, rtol=1e-4, atol=1e-4)
    mode = rng.standard_normal((4, 3, 5)).astype(np.float32)
    val = rng.standard_normal((4, 3, 5)).astype(np.float32)
    _close(td.SymlogDistribution(torch.tensor(mode), 1).log_prob(torch.tensor(val)),
           jd.SymlogDistribution(jnp.asarray(mode), 1).log_prob(jnp.asarray(val)))
    _close(td.MSEDistribution(torch.tensor(mode), 1).log_prob(torch.tensor(val)),
           jd.MSEDistribution(jnp.asarray(mode), 1).log_prob(jnp.asarray(val)))
    bl = rng.standard_normal((6, 1)).astype(np.float32)
    target = (rng.random((6, 1)) < 0.5).astype(np.float32)
    jb, tb = jd.Independent(jd.BernoulliSafeMode(jnp.asarray(bl)), 1), td.Independent(td.BernoulliSafeMode(torch.tensor(bl)), 1)
    _close(tb.log_prob(torch.tensor(target)), jb.log_prob(jnp.asarray(target)))
    _close(tb.base.mode, jb.base.mode)
    cl = rng.standard_normal((6, 4, 7)).astype(np.float32)
    jc, tc = jd.Independent(jd.OneHotCategorical(logits=jnp.asarray(cl)), 1), td.Independent(td.OneHotCategorical(torch.tensor(cl)), 1)
    _close(tc.entropy(), jc.entropy())
    onehot = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (6, 4))]
    _close(tc.log_prob(torch.tensor(onehot)), jc.log_prob(jnp.asarray(onehot)))
    loc, scale = rng.standard_normal((5, 2)).astype(np.float32), rng.uniform(0.2, 1.0, (5, 2)).astype(np.float32)
    v = rng.standard_normal((5, 2)).astype(np.float32)
    jn, tn = jd.Independent(jd.Normal(jnp.asarray(loc), jnp.asarray(scale)), 1), td.Independent(td.Normal(torch.tensor(loc), torch.tensor(scale)), 1)
    _close(tn.log_prob(torch.tensor(v)), jn.log_prob(jnp.asarray(v)))
    _close(tn.entropy(), jn.entropy())
    _close(tagent.uniform_mix(torch.tensor(cl.reshape(6, 28)), 7, 0.01), jagent.uniform_mix(jnp.asarray(cl.reshape(6, 28)), 7, 0.01))


def test_straight_through_sample_gradient_is_the_softmax():
    logits = torch.randn(3, 4, 5, generator=torch.Generator().manual_seed(0), requires_grad=True)
    g = td.gumbel((3, 4, 5), torch.Generator().manual_seed(1), "cpu")
    z = tagent.straight_through_sample(logits.reshape(3, 20), 5, g)
    assert torch.equal(z.detach(), torch.nn.functional.one_hot((logits + g).argmax(-1), 5).float())
    w = torch.randn(3, 4, 5)
    (z * w).sum().backward()
    probs = torch.softmax(logits.detach(), -1)
    np.testing.assert_allclose(logits.grad.numpy(), (probs * (w - (probs * w).sum(-1, keepdim=True))).numpy(), atol=1e-6)


def test_adam_with_clipping_matches_optax():
    rng = np.random.default_rng(6)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) * s for s in (50.0, 0.1, 20.0)]
    tx = jclip(jadam(lr=1e-3, eps=1e-5, betas=(0.9, 0.999)), 10.0)
    jp = jnp.asarray(w0)
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.tensor(w0))
    opt = tclip(tadam([tp], lr=1e-3, eps=1e-5, betas=(0.9, 0.999)), 10.0)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        tp.grad = torch.tensor(g)
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jnp.asarray(g))), rtol=1e-6)
    _close(tp, jp, rtol=1e-5, atol=1e-7)


def test_lambda_values_and_moments():
    rng = np.random.default_rng(7)
    r, v = rng.standard_normal((15, 8, 1)).astype(np.float32), rng.standard_normal((15, 8, 1)).astype(np.float32)
    c = (rng.random((15, 8, 1)) < 0.9).astype(np.float32) * 0.997
    ref = jutils.compute_lambda_values(jnp.asarray(r), jnp.asarray(v), jnp.asarray(c), lmbda=0.95)
    _close(tutils.compute_lambda_values(torch.tensor(r), torch.tensor(v), torch.tensor(c), lmbda=0.95), ref)
    state = jutils.init_moments()
    moments = tutils.Moments(0.99, 1.0, 0.05, 0.95)
    for _ in range(3):
        x = rng.standard_normal((15, 8, 1)).astype(np.float32) * 3
        j_off, j_inv, state = jutils.update_moments(state, jnp.asarray(x), 0.99, 1.0, 0.05, 0.95)
        t_off, t_inv = moments.update(torch.tensor(x))
        _close(t_off, j_off)
        _close(t_inv, j_inv)


def test_extract_step_params_matches_the_jax_dict(agents):
    """The 19-key dict of the fused step, from converted modules, is the JAX
    package's ``extract_step_params`` dict (matrices transposed)."""
    from sheeprl_tpu.ops.pallas import rssm_step as JK
    from sheeprl_tpu_torch.ops import rssm_step as TK

    _, params, wm, _, _ = agents
    ref = JK.extract_step_params(params["world_model"], wm.rssm.stoch_state_size)
    got = TK.extract_step_params(wm.rssm)
    assert set(got) == set(ref) == set(TK.PARAM_KEYS)
    for k in TK.PARAM_KEYS:
        g = got[k].detach().numpy()
        np.testing.assert_array_equal(g.T if g.ndim == 2 else g, np.asarray(ref[k]), err_msg=k)
