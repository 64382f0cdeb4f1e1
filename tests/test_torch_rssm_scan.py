"""The port's scan-level RSSM entry points against the JAX package's on the
CPU: the T-step dynamic scan and an H-step imagination rollout, both fed the
Gumbel fields the JAX side draws from its own keys (``fold_in(key, 1)`` for the
scan, ``rssm_step.py:724-726``; the step key for imagination). Float32; forward
rtol 1e-4 / atol 1e-5, gradients normwise at 1e-4 (see test_torch_rssm_step.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops.pallas import rssm_step as JK
from sheeprl_tpu_torch.ops import rssm_step as TK
from tests.test_torch_rssm_step import SHAPES, _assert_close, _assert_grad, _grad_to_jax_layout, _np_params, _spec_kwargs, _to_port


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_dynamic_scan_matches_jax_with_its_gumbel_field(shape):
    d = SHAPES[shape]
    T, Bs = 6, 3
    rng = np.random.default_rng(2)
    p_np = _np_params(d, rng)
    init_raw = (rng.standard_normal(d["R"]) * 0.3).astype(np.float32)
    emb = rng.standard_normal((T, Bs, d["E"])).astype(np.float32)
    act = rng.standard_normal((T, Bs, d["A"])).astype(np.float32)
    isf = (rng.random((T, Bs, 1)) < 0.3).astype(np.float32)
    isf[0] = 1.0
    key = jax.random.PRNGKey(3)
    jspec = JK.RSSMStepSpec(**_spec_kwargs(d, "float32"), impl="reference")
    tspec = TK.RSSMStepSpec(**_spec_kwargs(d, "float32"))
    w = [rng.standard_normal(s).astype(np.float32) for s in ((T, Bs, d["R"]), (T, Bs, d["S"], d["D"]),
                                                            (T, Bs, d["S"], d["D"]), (T, Bs, d["S"], d["D"]))]

    def jloss(p, init_raw, emb, act):
        outs = JK.fused_dynamic_scan(p, jspec, init_raw, emb, act, jnp.asarray(isf), key)
        return sum(jnp.sum(o * wi) for o, wi in zip(outs, w)), outs

    (j_loss, j_outs), j_grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        {k: jnp.asarray(v) for k, v in p_np.items()}, jnp.asarray(init_raw), jnp.asarray(emb), jnp.asarray(act))
    gumbel = np.asarray(jax.random.gumbel(jax.random.fold_in(key, 1), (T, Bs, d["S"], d["D"]), jnp.float32))

    p_t = _to_port(p_np, requires_grad=True)
    raw_t, emb_t, act_t = (torch.tensor(v, requires_grad=True) for v in (init_raw, emb, act))
    t_outs = TK.fused_dynamic_scan(p_t, tspec, raw_t, emb_t, act_t, torch.tensor(isf), torch.tensor(gumbel))
    t_loss = sum((o * torch.tensor(wi)).sum() for o, wi in zip(t_outs, w))
    t_loss.backward()

    for name, got, ref in zip(("recurrent_states", "posteriors", "priors_logits", "posteriors_logits"), t_outs, j_outs):
        _assert_close(name, got.detach().numpy(), np.asarray(ref), 1e-4, 1e-5)
    for k in TK.PARAM_KEYS:
        _assert_grad(k, _grad_to_jax_layout(k, p_t[k].grad), np.asarray(j_grads[0][k]), 1e-4)
    for name, t, g_j in zip(("init_raw", "embedded_obs", "actions"), (raw_t, emb_t, act_t), j_grads[1:]):
        _assert_grad(name, t.grad.numpy(), np.asarray(g_j), 1e-4)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_imagination_rollout_matches_jax_with_its_gumbel_fields(shape):
    d = SHAPES[shape]
    H, Bs = 4, 6
    rng = np.random.default_rng(4)
    p_np = _np_params(d, rng)
    SD = d["S"] * d["D"]
    prior0 = np.eye(d["D"], dtype=np.float32)[rng.integers(0, d["D"], (Bs, d["S"]))].reshape(Bs, SD)
    rec0 = np.tanh(rng.standard_normal((Bs, d["R"]))).astype(np.float32)
    acts = rng.standard_normal((H, Bs, d["A"])).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), H)
    jspec = JK.RSSMStepSpec(**_spec_kwargs(d, "float32"), impl="interpret")
    tspec = TK.RSSMStepSpec(**_spec_kwargs(d, "float32"))
    w = rng.standard_normal((H, Bs, d["R"])).astype(np.float32)

    def jloss(p, acts):
        prior, rec, total, states = jnp.asarray(prior0), jnp.asarray(rec0), 0.0, []
        for t in range(H):
            prior, rec = JK.fused_imagination_step(p, jspec, prior, rec, acts[t], keys[t])
            total = total + jnp.sum(rec * w[t]) + jnp.sum(prior * (t + 1))
            states.append(prior)
        return total, jnp.stack(states)

    (j_loss, j_priors), j_grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in p_np.items()}, jnp.asarray(acts))

    p_t = _to_port(p_np, requires_grad=True)
    acts_t = torch.tensor(acts, requires_grad=True)
    prior, rec, total, priors = torch.tensor(prior0), torch.tensor(rec0), 0.0, []
    pc = TK.compute_params(p_t, tspec)
    for t in range(H):
        g = np.asarray(jax.random.gumbel(keys[t], (Bs, d["S"], d["D"]), jnp.float32))
        prior, rec = TK.fused_imagination_step(p_t, tspec, prior, rec, acts_t[t], torch.tensor(g), pc)
        total = total + (rec * torch.tensor(w[t])).sum() + (prior * (t + 1)).sum()
        priors.append(prior)
    total.backward()

    np.testing.assert_array_equal(torch.stack(priors).detach().numpy(), np.asarray(j_priors))
    np.testing.assert_allclose(float(total.detach()), float(j_loss), rtol=1e-5)
    for k in ("wi_z", "wi_a", "wg_h", "wg_f", "wt", "wt_head", "bt_head", "ln_g_scale", "ln_t_bias"):
        _assert_grad(k, _grad_to_jax_layout(k, p_t[k].grad), np.asarray(j_grads[0][k]), 1e-4)
    _assert_grad("actions", acts_t.grad.numpy(), np.asarray(j_grads[1]), 1e-4)
