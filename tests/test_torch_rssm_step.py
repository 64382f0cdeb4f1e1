"""The port's fused RSSM step (``sheeprl_tpu_torch/ops/rssm_step.py``) against
the JAX package's (``sheeprl_tpu/ops/pallas/rssm_step.py``) on the CPU.

The JAX side runs its Pallas kernel through the interpreter (``interpret``) and
its plain formulation (``reference``), as ``tests/test_ops/test_pallas_rssm.py``
does; the port's side runs its ``autograd.Function``s, whose wrappers take the
plain PyTorch version for CPU tensors. Inputs come from numpy with a seed;
parameters in the JAX orientation ``[in, out]`` are transposed into the port's
``[out, in]``. Tolerances: float32 rtol 1e-4 / atol 1e-5; bfloat16 rtol and
atol 2e-2 (bf16 rounds at other places in XLA and PyTorch); one-hot samples
equal wherever the top-2 margin of ``logits + gumbel`` exceeds 1e-3 (float32)
or 5e-2 (bfloat16). Gradients are held normwise (``max|d| <= tol * max|ref|``)
because a bf16 rounding difference in an intermediate moves a gradient entry by
a fraction of the largest entry, not of its own size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops.pallas import rssm_step as JK
from sheeprl_tpu_torch.ops import rssm_step as TK

SHAPES = {
    "cartpole": dict(A=2, E=16, DU=24, R=32, HT=20, HR=28, S=4, D=6),
    "walker_walk": dict(A=6, E=64, DU=48, R=64, HT=48, HR=48, S=8, D=8),
}
TOL = {"float32": dict(rtol=1e-4, atol=1e-5, margin=1e-3), "bfloat16": dict(rtol=2e-2, atol=2e-2, margin=5e-2)}
MATRICES = ("wi_z", "wi_a", "wg_h", "wg_f", "wt", "wt_head", "wr_h", "wr_e", "wr_head")
B = 5


def _spec_kwargs(d, dtype):
    return dict(action_size=d["A"], embed_size=d["E"], dense_units=d["DU"], recurrent_size=d["R"],
                trans_hidden=d["HT"], repr_hidden=d["HR"], stochastic=d["S"], discrete=d["D"], unimix=0.01,
                eps_in=1e-3, eps_gru=1e-3, eps_trans=1e-3, eps_repr=1e-3, dtype=dtype)


def _np_params(d, rng):
    SD = d["S"] * d["D"]
    shapes = {"wi_z": (SD, d["DU"]), "wi_a": (d["A"], d["DU"]), "wg_h": (d["R"], 3 * d["R"]),
              "wg_f": (d["DU"], 3 * d["R"]), "wt": (d["R"], d["HT"]), "wt_head": (d["HT"], SD),
              "wr_h": (d["R"], d["HR"]), "wr_e": (d["E"], d["HR"]), "wr_head": (d["HR"], SD)}
    p = {k: (rng.standard_normal(s) * 0.2).astype(np.float32) for k, s in shapes.items()}
    for key, n in (("i", d["DU"]), ("g", 3 * d["R"]), ("t", d["HT"]), ("r", d["HR"])):
        p[f"ln_{key}_scale"] = (1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32)
        p[f"ln_{key}_bias"] = (0.05 * rng.standard_normal(n)).astype(np.float32)
    p["bt_head"] = (0.05 * rng.standard_normal(SD)).astype(np.float32)
    p["br_head"] = (0.05 * rng.standard_normal(SD)).astype(np.float32)
    return p


def _to_port(p_np, requires_grad=False):
    return {k: torch.tensor(v.T.copy() if k in MATRICES else v, requires_grad=requires_grad) for k, v in p_np.items()}


def _grad_to_jax_layout(k, g):
    g = g.detach().float().numpy()
    return g.T if k in MATRICES else g


def _step_inputs(d, rng, batch=B):
    SD = d["S"] * d["D"]
    onehot = lambda: np.eye(d["D"], dtype=np.float32)[rng.integers(0, d["D"], (batch, d["S"]))].reshape(batch, SD)  # noqa: E731
    return dict(
        init_h=np.tanh(rng.standard_normal((batch, d["R"]))).astype(np.float32),
        init_z=onehot(),
        h=np.tanh(rng.standard_normal((batch, d["R"]))).astype(np.float32),
        z=onehot(),
        a=rng.standard_normal((batch, d["A"])).astype(np.float32),
        e=rng.standard_normal((batch, d["E"])).astype(np.float32),
        f=(rng.random((batch, 1)) < 0.4).astype(np.float32),
        g=rng.gumbel(size=(batch, d["S"], d["D"])).astype(np.float32),
    )


def _assert_close(name, got, ref, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32), rtol=rtol, atol=atol,
                               err_msg=name)


def _assert_grad(name, got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err = float(np.max(np.abs(got - ref))) if got.size else 0.0
    scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    assert err <= tol * scale + 1e-7, f"gradient {name}: max|d|={err:.3e} > {tol} * max|ref| ({scale:.3e})"


def _assert_samples(z_port, z_jax, logits, g, margin):
    D = logits.shape[-1]
    y = (np.asarray(logits, np.float32) + g).reshape(-1, D)
    top2 = np.sort(y, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > margin
    zp = np.asarray(z_port, np.float32).reshape(-1, D)
    zj = np.asarray(z_jax, np.float32).reshape(-1, D)
    assert clear.sum() > 0
    assert np.array_equal(zp[clear], zj[clear]), "one-hot samples differ at clear margins"


def _cotangents(rng, outs):
    return [rng.standard_normal(np.shape(o)).astype(np.float32) for o in outs]


def _jdtype(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


@pytest.mark.parametrize("impl", ["interpret", "reference"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_dyn_step_matches_jax(shape, dtype, impl):
    d, tol = SHAPES[shape], TOL[dtype]
    rng = np.random.default_rng(0)
    p_np, x = _np_params(d, rng), _step_inputs(d, rng)
    jspec = JK.RSSMStepSpec(**_spec_kwargs(d, dtype), impl=impl)
    tspec = TK.RSSMStepSpec(**_spec_kwargs(d, dtype))
    jc, tc = _jdtype(dtype), tspec.compute_dtype
    carried = ("init_h", "init_z", "h", "z")

    jx = {k: jnp.asarray(v, jc if k in carried else jnp.float32) for k, v in x.items()}
    p_j = {k: jnp.asarray(v) for k, v in p_np.items()}
    diff = ("init_h", "init_z", "h", "z", "a", "e")

    def jfn(p, init_h, init_z, h, z, a, e):
        return JK._fused_step(jspec, p, init_h, init_z, h, z, a, e, jx["f"], jx["g"])

    j_outs, vjp = jax.vjp(jfn, p_j, *(jx[k] for k in diff))
    cts = _cotangents(rng, j_outs)
    j_grads = vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cts, j_outs)))

    p_t = _to_port(p_np, requires_grad=True)
    tx = {k: torch.tensor(v).to(tc if k in carried else torch.float32).requires_grad_(k in diff) for k, v in x.items()}
    pc = TK.compute_params(p_t, tspec)
    t_outs = TK.DynStep.apply(tspec, pc, *tx.values(), *(p_t[k] for k in TK.PARAM_KEYS))
    torch.autograd.backward(t_outs, [torch.tensor(c).to(o.dtype) for c, o in zip(cts, t_outs)])

    for name, got, ref in zip(("h_new", "post_logits", "prior_logits"), (t_outs[0], t_outs[2], t_outs[3]),
                              (j_outs[0], j_outs[2], j_outs[3])):
        _assert_close(name, got.detach().float().numpy(), np.asarray(ref, np.float32), tol["rtol"], tol["atol"])
    assert t_outs[2].dtype == torch.float32 and t_outs[3].dtype == torch.float32
    assert t_outs[0].dtype == tc and t_outs[1].dtype == tc
    _assert_samples(t_outs[1].detach().float().numpy(), np.asarray(j_outs[1], np.float32),
                    np.asarray(j_outs[2], np.float32), x["g"], tol["margin"])

    dp_j = j_grads[0]
    for k in TK.PARAM_KEYS:
        _assert_grad(k, _grad_to_jax_layout(k, p_t[k].grad), np.asarray(dp_j[k], np.float32), tol["rtol"])
    for k, g_j in zip(diff, j_grads[1:]):
        _assert_grad(k, tx[k].grad.float().numpy(), np.asarray(g_j, np.float32), tol["rtol"])


@pytest.mark.parametrize("impl", ["interpret", "reference"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_imag_step_matches_jax(shape, dtype, impl):
    d, tol = SHAPES[shape], TOL[dtype]
    rng = np.random.default_rng(1)
    p_np, x = _np_params(d, rng), _step_inputs(d, rng, batch=7)
    x = {k: x[k] for k in ("h", "z", "a", "g")}
    jspec = JK.RSSMStepSpec(**_spec_kwargs(d, dtype), impl=impl)
    tspec = TK.RSSMStepSpec(**_spec_kwargs(d, dtype))
    jc, tc = _jdtype(dtype), tspec.compute_dtype
    jx = {k: jnp.asarray(v, jc if k in ("h", "z") else jnp.float32) for k, v in x.items()}
    p_j = {k: jnp.asarray(v) for k, v in p_np.items()}

    def jfn(p, h, z, a):
        return JK._fused_imag_step(jspec, p, h, z, a, jx["g"])

    j_outs, vjp = jax.vjp(jfn, p_j, jx["h"], jx["z"], jx["a"])
    cts = _cotangents(rng, j_outs)
    j_grads = vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cts, j_outs)))

    p_t = _to_port(p_np, requires_grad=True)
    tx = {k: torch.tensor(v).to(tc if k in ("h", "z") else torch.float32).requires_grad_(k != "g") for k, v in x.items()}
    t_outs = TK.ImagStep.apply(tspec, TK.compute_params(p_t, tspec), *tx.values(), *(p_t[k] for k in TK.PARAM_KEYS))
    torch.autograd.backward(t_outs, [torch.tensor(c).to(o.dtype) for c, o in zip(cts, t_outs)])

    _assert_close("h_new", t_outs[0].detach().float().numpy(), np.asarray(j_outs[0], np.float32), tol["rtol"], tol["atol"])
    with torch.no_grad():
        _, prior_logits = TK._gru_prior(_to_port(p_np), tspec, tx["z"], tx["a"].to(tc), tx["h"])
    _assert_samples(t_outs[1].float().detach().numpy(), np.asarray(j_outs[1], np.float32), prior_logits.numpy(),
                    x["g"], tol["margin"])
    for k in TK.PARAM_KEYS:
        ref = np.asarray(j_grads[0][k], np.float32)
        got = p_t[k].grad
        if got is None:  # representation branch: untouched by imagination
            assert not np.any(ref), k
            continue
        _assert_grad(k, _grad_to_jax_layout(k, got), ref, tol["rtol"])
    for k, g_j in zip(("h", "z", "a"), j_grads[1:]):
        _assert_grad(k, tx[k].grad.float().numpy(), np.asarray(g_j, np.float32), tol["rtol"])


def test_wrappers_refuse_other_devices_and_reference_refuses_cuda():
    d = SHAPES["cartpole"]
    spec = TK.RSSMStepSpec(**_spec_kwargs(d, "float32"))
    p = {k: v.to("meta") for k, v in _to_port(_np_params(d, np.random.default_rng(0))).items()}
    h = torch.empty(2, d["R"], device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        TK.rssm_imag_step(spec, p, h, torch.empty(2, 24, device="meta"), torch.empty(2, 2, device="meta"),
                          torch.empty(2, 4, 6, device="meta"))
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import MLPWithHead, RecurrentModel, RSSM

    rssm = RSSM(RecurrentModel(26, 32, 24), MLPWithHead(48, [28], 24), MLPWithHead(32, [20], 24), 4, 6,
                kernels="reference")
    with pytest.raises(ValueError, match="CPU only"):
        rssm.imagination_args(torch.device("cuda"), 2)


def test_kernel_operand_checks_name_the_bad_operand():
    """The checks the CUDA wrappers run before a launch, on CPU tensors."""
    d = SHAPES["walker_walk"]
    spec = TK.RSSMStepSpec(**_spec_kwargs(d, "float32"))
    pc = TK.compute_params(_to_port(_np_params(d, np.random.default_rng(0))), spec)
    h = torch.zeros(2, d["R"])
    TK._check_operands(spec, pc, {"h": (h, (2, d["R"]), torch.float32)}, TK.PARAM_KEYS)
    with pytest.raises(ValueError, match="parameter wt_head"):
        TK._check_operands(spec, dict(pc, wt_head=pc["wt_head"][:, 1:]), {"h": (h, (2, d["R"]), torch.float32)},
                           TK.PARAM_KEYS)
    with pytest.raises(ValueError, match="parameter wg_h"):
        TK._check_operands(spec, dict(pc, wg_h=pc["wg_h"].to(torch.bfloat16)), {"h": (h, (2, d["R"]), torch.float32)},
                           TK.PARAM_KEYS)
    with pytest.raises(ValueError, match="h: expected contiguous"):
        TK._check_operands(spec, pc, {"h": (h.t(), (2, d["R"]), torch.float32)}, TK.PARAM_KEYS)
    wi = torch.cat([pc["wi_z"], pc["wi_a"]], dim=1)  # a column slice has row stride SD + A, not repacked
    with pytest.raises(ValueError, match="parameter wi_z must be contiguous and 16-byte aligned"):
        TK._check_operands(spec, dict(pc, wi_z=wi[:, : spec.stoch_flat]), {"h": (h, (2, d["R"]), torch.float32)},
                           TK.PARAM_KEYS)
    shifted = torch.zeros(2 * d["R"] + 1)[1:].view(2, d["R"])  # contiguous, 4 bytes past an aligned start
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="h: the kernel reads it with 16-byte loads"):
        TK._check_operands(spec, pc, {"h": (shifted, (2, d["R"]), torch.float32)}, TK.PARAM_KEYS)
    a = torch.zeros(2 * d["A"] + 1)[1:].view(2, d["A"])  # the action is a rank update: no alignment needed
    TK._check_operands(spec, pc, {"a": (a, (2, d["A"]), torch.float32)}, TK.PARAM_KEYS)


def test_unsupported_structure_raises_naming_the_field():
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import MLPWithHead, RecurrentModel, RSSM

    rssm = RSSM(RecurrentModel(26, 32, 24), MLPWithHead(48, [28, 28], 24), MLPWithHead(32, [20], 24), 4, 6,
                kernels="auto")
    with pytest.raises(TK.KernelUnsupported, match="representation_model"):
        rssm.dynamic_scan(torch.zeros(3, 2, 16), torch.zeros(3, 2, 2), torch.ones(3, 2, 1), torch.zeros(3, 2, 4, 6))
    rssm = RSSM(RecurrentModel(26, 32, 24), MLPWithHead(48, [28], 24, activation="relu"), MLPWithHead(32, [20], 24),
                4, 6, kernels="auto")
    with pytest.raises(TK.KernelUnsupported, match="dense_act"):
        rssm.dynamic_scan(torch.zeros(3, 2, 16), torch.zeros(3, 2, 2), torch.ones(3, 2, 1), torch.zeros(3, 2, 4, 6))
    with pytest.raises(ValueError, match="kernels"):
        RSSM(RecurrentModel(26, 32, 24), MLPWithHead(48, [28], 24), MLPWithHead(32, [20], 24), 4, 6, kernels="pallas")
