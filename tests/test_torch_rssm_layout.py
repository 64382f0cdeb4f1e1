"""Host-side layout of the port's CUDA RSSM-step kernels on the CPU.

The kernels read matrices that ``compute_params`` repacks into contiguous,
16-byte aligned buffers, stream every product's K width as 16-byte vectors, and
split the dynamic step's products over the card's SMs by ``dyn_plan``. What of
that lives in Python is held here: the plain version on the repacked parameters
against the JAX package's reference (the formulation the kernels must match),
the checks that name what a kernel cannot take, and the split-K plan.
Tolerances as in ``tests/test_torch_rssm_step.py``: float32 rtol 1e-4 /
atol 1e-5, bfloat16 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops.pallas import rssm_step as JK
from sheeprl_tpu_torch.ops import rssm_step as TK
from tests.test_torch_rssm_step import SHAPES, TOL, _np_params, _spec_kwargs, _step_inputs, _to_port

DV3_S = dict(A=2, E=4096, DU=512, R=512, HT=512, HR=512, S=32, D=32)
H100_SMS = 132
#: opt-in shared memory per block of an H100, in bytes
H100_SMEM_OPTIN = 232448


def _spec(d, dtype="bfloat16", **over):
    return TK.RSSMStepSpec(**{**_spec_kwargs(d, dtype), **over})


def _sliced_port_params(p_np, spec):
    """The parameters as ``extract_step_params`` hands them over from the
    modules: each two-operand product's matrices are column slices of one
    ``Linear`` weight (row stride K1 + K2, not 16-byte aligned in float32)."""
    p32 = _to_port(p_np)
    for w1, w2 in (("wi_z", "wi_a"), ("wg_h", "wg_f"), ("wr_h", "wr_e")):
        fused = torch.cat([p32[w1], p32[w2]], dim=1)
        k1 = p32[w1].shape[1]
        p32[w1], p32[w2] = fused[:, :k1], fused[:, k1:]
    assert not p32["wi_z"].is_contiguous() and not p32["wr_e"].is_contiguous()
    return p32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_compute_params_repacks_each_matrix_into_its_own_aligned_buffer(shape, dtype):
    spec = _spec(SHAPES[shape], dtype)
    p32 = _sliced_port_params(_np_params(SHAPES[shape], np.random.default_rng(3)), spec)
    pc = TK.compute_params(p32, spec)
    for k in TK.PARAM_KEYS:
        want = torch.float32 if k.startswith("ln_") else spec.compute_dtype
        assert pc[k].dtype == want, k
        assert torch.equal(pc[k], p32[k].to(want)), k
        if not k.startswith("ln_"):
            assert pc[k].is_contiguous() and pc[k].data_ptr() % 16 == 0, k
            assert not pc[k].requires_grad, k


@pytest.mark.parametrize("kind", ["dyn", "imag"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_version_on_repacked_params_matches_jax(shape, dtype, kind):
    """The formulation the CUDA kernels are held to on the card, fed what
    ``compute_params`` repacks from the column slices the modules hand over,
    against the JAX package's plain reference."""
    d, tol = SHAPES[shape], TOL[dtype]
    rng = np.random.default_rng(5)
    p_np, x = _np_params(d, rng), _step_inputs(d, rng, batch=6)
    jspec = JK.RSSMStepSpec(**_spec_kwargs(d, dtype), impl="reference")
    spec = _spec(d, dtype)
    jc, tc = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    carried = ("init_h", "init_z", "h", "z")
    jx = {k: jnp.asarray(v, jc if k in carried else jnp.float32) for k, v in x.items()}
    tx = {k: torch.tensor(v).to(tc if k in carried else torch.float32) for k, v in x.items()}
    p_j = {k: jnp.asarray(v) for k, v in p_np.items()}
    pc = TK.compute_params(_sliced_port_params(p_np, spec), spec)
    with torch.no_grad():
        if kind == "dyn":
            j_outs = JK._fused_step(jspec, p_j, *(jx[k] for k in ("init_h", "init_z", "h", "z", "a", "e", "f", "g")))
            t_outs = TK.rssm_dyn_step(spec, pc, *tx.values())
            pairs = zip(("h_new", "post_logits", "prior_logits"), (t_outs[0], t_outs[2], t_outs[3]),
                        (j_outs[0], j_outs[2], j_outs[3]))
        else:
            j_outs = JK._fused_imag_step(jspec, p_j, jx["h"], jx["z"], jx["a"], jx["g"])
            t_outs = TK.rssm_imag_step(spec, pc, tx["h"], tx["z"], tx["a"], tx["g"])
            pairs = [("h_new", t_outs[0], j_outs[0])]
    for name, got, ref in pairs:
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=tol["rtol"],
                                   atol=tol["atol"], err_msg=name)
    assert t_outs[0].dtype == tc and t_outs[1].dtype == tc


@pytest.mark.parametrize(
    "kind, over, field",
    [
        ("imag", {}, "trans_hidden=20"),  # cartpole's transition width
        ("dyn", {"trans_hidden": 24}, "repr_hidden=28"),
        ("dyn", {"trans_hidden": 24, "repr_hidden": 32, "embed_size": 18}, "embed_size=18"),
        ("imag", {"discrete": 5}, "stoch_flat=20"),
        ("imag", {"dense_units": 12}, "dense_units=12"),
        ("dyn", {"recurrent_size": 36, "trans_hidden": 24, "repr_hidden": 32}, "recurrent_size=36"),
    ],
)
def test_kernel_shape_check_names_the_width(kind, over, field):
    with pytest.raises(TK.KernelUnsupported, match=field):
        TK.check_kernel_shapes(_spec(SHAPES["cartpole"], **over), kind, H100_SMEM_OPTIN)


@pytest.mark.parametrize(
    "dims, over",
    [
        (SHAPES["walker_walk"], {}),
        (DV3_S, {}),
        (SHAPES["cartpole"], {"trans_hidden": 24, "repr_hidden": 32, "embed_size": 0}),  # imag reads no embedding
    ],
)
def test_kernel_shape_check_accepts_widths_of_multiples_of_8(dims, over):
    spec = _spec(dims, **over)
    TK.check_kernel_shapes(spec, "imag", H100_SMEM_OPTIN)
    if spec.embed_size:
        TK.check_kernel_shapes(spec, "dyn", H100_SMEM_OPTIN)


@pytest.mark.parametrize(
    "dims, batch, n_sms",
    [(DV3_S, 16, H100_SMS), (DV3_S, 17, H100_SMS), (DV3_S, 64, H100_SMS), (DV3_S, 16, 8),
     (SHAPES["walker_walk"], 5, H100_SMS), (dict(SHAPES["cartpole"], HT=24, HR=32), 3, H100_SMS)],
)
def test_dyn_plan_covers_every_product_in_whole_32_wide_chunks(dims, batch, n_sms):
    assert_plan_covers_every_product(_spec(dims), batch, n_sms)


def assert_plan_covers_every_product(spec, batch, n_sms):
    """Each half's chunks cover all of K with no empty chunk, and its partial
    sums fill the workspace right after the previous half's."""
    plan = TK.dyn_plan(spec, batch, n_sms)
    assert plan.grid == n_sms
    offset = 0
    for (_, k_field, n_field), kc, splits, part_off in zip(TK.DYN_HALVES, plan.kc, plan.splits, plan.part_off):
        K, N = TK._width(spec, k_field), TK._width(spec, n_field)
        assert kc % 32 == 0 and kc >= 32
        assert (splits - 1) * kc < K <= splits * kc, (k_field, K, kc, splits)
        assert part_off == offset, k_field
        offset += splits * batch * N
    assert plan.workspace == offset
    assert TK.dyn_plan(spec, batch, n_sms) is plan  # planned once per shape, not per step


def test_dyn_plan_spreads_every_dv3_s_product_over_every_sm():
    """At the main path's batch each product half has at least one warp unit
    (16 rows x 8 columns x a K chunk) per SM, and about half a unit per warp of
    the cooperative grid."""
    spec = _spec(DV3_S)
    plan = TK.dyn_plan(spec, 16, H100_SMS)
    target = H100_SMS * TK.DYN_BLOCK_WARPS // 2
    for (_, _, n_field), splits in zip(TK.DYN_HALVES, plan.splits):
        units = -(-TK._width(spec, n_field) // 8) * splits
        assert H100_SMS <= units <= 2 * target, n_field
    assert plan.kc == (64, 96, 96, 32, 64, 32, 256, 64)


def test_dyn_plan_refuses_a_workspace_past_32_bit_offsets():
    with pytest.raises(TK.KernelUnsupported, match="batch=400000"):
        TK.dyn_plan(_spec(DV3_S), 400000, H100_SMS)


def test_device_launch_counts_cover_every_wrapper():
    assert set(TK.DEVICE_LAUNCHES_PER_CALL) == set(TK.LAUNCHES)
    assert TK.DEVICE_LAUNCHES_PER_CALL == {"rssm_dyn_step": 1, "rssm_imag_step": 8}
