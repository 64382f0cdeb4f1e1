"""The DreamerV3 size presets (XS, S, M, L, XL) in the port, on the CPU.

- Each preset composes to the JAX package's values on every key of the port's
  config; only the class paths differ, re-pointed from ``sheeprl_tpu.`` to
  ``sheeprl_tpu_torch.``.
- At the real RSSM widths of M and L, batch 2, one dynamic and one imagination
  step of the port's plain version against the JAX package's ``reference``
  formulation (what the JAX package itself runs at these widths on a TPU,
  where its Pallas kernels exceed their VMEM budget). Both sides read one
  numpy parameter tree in the flax layout: the JAX side through
  ``extract_step_params``, the port through ``compat/flax_params.py``, its
  modules and its own ``extract_step_params``. The Gumbel field is shared.
  Tolerances as in ``tests/test_torch_rssm_step.py``: float32 rtol 1e-4 /
  atol 1e-5, bfloat16 2e-2, gradients (float32) normwise 1e-4 of each
  parameter's largest entry.
- At all five presets and at widths made too wide on purpose, the split-K plan
  of the dynamic kernel and the shared-memory precondition, for an assumed H100
  SXM: 132 SMs, 227 KB (232,448 bytes) of opt-in shared memory per block.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.config import compose as jcompose
from sheeprl_tpu.ops.pallas import rssm_step as JK
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tagent
from sheeprl_tpu_torch.compat import flax_params
from sheeprl_tpu_torch.config import compose as tcompose
from sheeprl_tpu_torch.ops import rssm_step as TK
from tests.test_torch_rssm_layout import H100_SMEM_OPTIN as SMEM_OPTIN, assert_plan_covers_every_product
from tests.test_torch_rssm_step import TOL, _assert_grad, _assert_samples

PRESETS = ("XS", "S", "M", "L", "XL")
SM_COUNT = 132
B = 2


def _overrides(size):
    # a fixed run name: the default one holds the time of composition
    return ["exp=dreamer_v3", f"algo=dreamer_v3_{size}", "env=dummy", "run_name=preset"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _spec(size, dtype="bfloat16", **changes):
    """The fused step's spec of a preset, from the port's composed config, at
    64x64 rgb on discrete_dummy (2 actions): the 4-stage CNN encoder gives
    8 * multiplier * 4 * 4 features."""
    wm = tcompose(_overrides(size)).algo.world_model
    spec = TK.RSSMStepSpec(
        action_size=2, embed_size=8 * int(wm.encoder.cnn_channels_multiplier) * 16,
        dense_units=int(wm.recurrent_model.dense_units), recurrent_size=int(wm.recurrent_model.recurrent_state_size),
        trans_hidden=int(wm.transition_model.hidden_size), repr_hidden=int(wm.representation_model.hidden_size),
        stochastic=int(wm.stochastic_size), discrete=int(wm.discrete_size), unimix=0.01,
        eps_in=1e-3, eps_gru=1e-3, eps_trans=1e-3, eps_repr=1e-3, dtype=dtype)
    return dataclasses.replace(spec, **changes)


@pytest.mark.parametrize("size", PRESETS)
def test_preset_config_matches_jax(size):
    port, ref = _flat(tcompose(_overrides(size))), _flat(jcompose("config", _overrides(size)))
    for key, value in port.items():
        assert key in ref, key
        if isinstance(value, str) and value.startswith("sheeprl_tpu_torch."):
            value = "sheeprl_tpu." + value[len("sheeprl_tpu_torch."):]
        assert value == ref[key], f"{key}: port {value!r}, JAX {ref[key]!r}"
    assert port["algo.world_model.kernels"] is False  # `off`: the module path unless kernels=auto is asked for


def test_presets_widths():
    """The RSSM widths of the table the kernels are checked at (chip_smoke.SIZES)."""
    got = {s: (_spec(s).recurrent_size, _spec(s).dense_units, _spec(s).trans_hidden, _spec(s).repr_hidden,
               _spec(s).embed_size) for s in PRESETS}
    assert got == {"XS": (256, 256, 256, 256, 3072), "S": (512, 512, 512, 512, 4096),
                   "M": (1024, 640, 640, 640, 6144), "L": (2048, 768, 768, 768, 8192),
                   "XL": (4096, 1024, 1024, 1024, 12288)}


# --------------------------------------------------------------------------- #
# dyn_plan and the shared-memory precondition
# --------------------------------------------------------------------------- #

TOO_WIDE = {"recurrent_size": 8192}


@pytest.mark.parametrize("batch", [16, 17])
@pytest.mark.parametrize("size", PRESETS + ("XL+",))
def test_dyn_plan_covers_every_product(size, batch):
    spec = _spec("XL", **TOO_WIDE) if size == "XL+" else _spec(size)
    assert_plan_covers_every_product(spec, batch, SM_COUNT)
    assert TK.dyn_plan(spec, batch, SM_COUNT).workspace < 2**31


@pytest.mark.parametrize("size", PRESETS)
def test_presets_fit_the_cards_shared_memory(size):
    spec = _spec(size)
    DU, R, HT, HR, D = spec.dense_units, spec.recurrent_size, spec.trans_hidden, spec.repr_hidden, spec.discrete
    assert TK.dyn_smem_bytes(spec) == 4 * max(2 * DU, 10 * R, 2 * HT, 3 * HR, 64 * D)
    assert max(TK.smem_floats(spec, "imag").values()) == max(DU, 4 * R, HT, 32 * D)
    for kind in ("dyn", "imag"):
        TK.check_kernel_shapes(spec, kind, SMEM_OPTIN)
    if size == "XL":
        assert TK.dyn_smem_bytes(spec) == 163840  # 160 KB: one block per SM still fits


@pytest.mark.parametrize("kind, field, value", [
    ("dyn", "recurrent_size", 8192), ("imag", "recurrent_size", 16384),
    ("dyn", "dense_units", 32768), ("dyn", "repr_hidden", 20480), ("imag", "trans_hidden", 65536),
])
def test_too_wide_spec_names_the_field(kind, field, value):
    spec = _spec("XL", **{field: value})
    with pytest.raises(TK.KernelUnsupported, match=rf"^{field}={value}: .*{SMEM_OPTIN} bytes"):
        TK.check_kernel_shapes(spec, kind, SMEM_OPTIN)
    TK.check_kernel_shapes(spec, kind, 2**31)  # its product widths alone are fine


# --------------------------------------------------------------------------- #
# the plain steps at the real M and L widths against the JAX reference
# --------------------------------------------------------------------------- #


def _flax_rssm_tree(spec, rng):
    """A random RSSM parameter tree in the JAX package's flax layout."""
    SD, A, DU, R = spec.stoch_flat, spec.action_size, spec.dense_units, spec.recurrent_size
    HT, HR, E = spec.trans_hidden, spec.repr_hidden, spec.embed_size

    def dense(n_in, n_out, bias=False):
        d = {"kernel": (rng.standard_normal((n_in, n_out)) / np.sqrt(n_in)).astype(np.float32)}
        if bias:
            d["bias"] = (0.05 * rng.standard_normal(n_out)).astype(np.float32)
        return d

    def ln(n):
        return {"LayerNorm_0": {"scale": (1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32),
                                "bias": (0.05 * rng.standard_normal(n)).astype(np.float32)}}

    gru, gru_ln = dense(R + DU, 3 * R), ln(3 * R)["LayerNorm_0"]
    gru.update(ln_scale=gru_ln["scale"], ln_bias=gru_ln["bias"])
    return {
        "recurrent_model": {"params": {"MLP_0": {"Dense_0": dense(SD + A, DU), "LayerNorm_0": ln(DU)},
                                       "LayerNormGRUCell_0": gru}},
        "transition_model": {"params": {"MLP_0": {"Dense_0": dense(R, HT), "LayerNorm_0": ln(HT)},
                                        "head": dense(HT, SD, bias=True)}},
        "representation_model": {"params": {"MLP_0": {"Dense_0": dense(R + E, HR), "LayerNorm_0": ln(HR)},
                                            "head": dense(HR, SD, bias=True)}},
    }


def _port_params(spec, tree):
    """flax tree -> the port's RSSM modules (flax_params) -> the flat step dict."""
    SD, R = spec.stoch_flat, spec.recurrent_size
    rec = tagent.RecurrentModel(SD + spec.action_size, R, spec.dense_units)
    trans = tagent.MLPWithHead(R, [spec.trans_hidden], SD)
    rep = tagent.MLPWithHead(R + spec.embed_size, [spec.repr_hidden], SD)
    rec.load_state_dict(flax_params.to_state_dict(tree["recurrent_model"]), strict=True)
    trans.load_state_dict(flax_params.to_state_dict(tree["transition_model"]), strict=True)
    rep.load_state_dict(flax_params.to_state_dict(tree["representation_model"]), strict=True)
    rssm = tagent.RSSM(rec, rep, trans, spec.stochastic, spec.discrete, spec.unimix, kernels="reference")
    return {k: v.detach().clone().requires_grad_(True) for k, v in TK.extract_step_params(rssm).items()}


@pytest.fixture(scope="module", params=["M", "L"])
def preset(request):
    spec = _spec(request.param, "float32")
    rng = np.random.default_rng({"M": 0, "L": 1}[request.param])
    tree = _flax_rssm_tree(spec, rng)
    SD, S, D, R = spec.stoch_flat, spec.stochastic, spec.discrete, spec.recurrent_size
    onehot = lambda: np.eye(D, dtype=np.float32)[rng.integers(0, D, (B, S))].reshape(B, SD)  # noqa: E731
    x = dict(init_h=np.tanh(rng.standard_normal((B, R))).astype(np.float32), init_z=onehot(),
             h=np.tanh(rng.standard_normal((B, R))).astype(np.float32), z=onehot(),
             a=np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)],
             e=rng.standard_normal((B, spec.embed_size)).astype(np.float32),
             f=np.array([[1.0], [0.0]], np.float32), g=rng.gumbel(size=(B, S, D)).astype(np.float32))
    return request.param, spec, tree, x, rng


def _to_jax_layout(g):
    g = g.detach().float().numpy()
    return g.T if g.ndim == 2 else g


@pytest.mark.parametrize("kind", ["dyn", "imag"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_step_matches_jax_reference_at_preset_width(preset, dtype, kind):
    size, spec32, tree, x, rng = preset
    spec, tol = dataclasses.replace(spec32, dtype=dtype), TOL[dtype]
    jspec = JK.RSSMStepSpec(**{f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}, impl="reference")
    jc, tc = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    carried = ("init_h", "init_z", "h", "z")
    names = ("init_h", "init_z", "h", "z", "a", "e", "f", "g") if kind == "dyn" else ("h", "z", "a", "g")
    diff = [k for k in names if k not in ("f", "g")]
    p_j = JK.extract_step_params(jax.tree_util.tree_map(jnp.asarray, tree), spec.stoch_flat)
    jx = {k: jnp.asarray(x[k], jc if k in carried else jnp.float32) for k in names}

    def jfn(p, *xs):
        args = dict(zip(diff, xs), f=jx.get("f"), g=jx["g"])
        if kind == "dyn":
            return JK._fused_step(jspec, p, *(args[k] for k in names))
        return JK._fused_imag_step(jspec, p, *(args[k] for k in names))

    p_t = _port_params(spec, tree)
    tx = {k: torch.tensor(x[k]).to(tc if k in carried else torch.float32).requires_grad_(k in diff) for k in names}
    fn = TK.DynStep if kind == "dyn" else TK.ImagStep
    t_outs = fn.apply(spec, TK.compute_params(p_t, spec), *tx.values(), *(p_t[k] for k in TK.PARAM_KEYS))

    if dtype == "bfloat16":
        j_outs = jfn(p_j, *(jx[k] for k in diff))
    else:
        j_outs, vjp = jax.vjp(jfn, p_j, *(jx[k] for k in diff))
        cts = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in j_outs]
        j_grads = vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cts, j_outs)))
        torch.autograd.backward(t_outs, [torch.tensor(c).to(o.dtype) for c, o in zip(cts, t_outs)])

    checked = (0, 2, 3) if kind == "dyn" else (0,)
    for i in checked:
        np.testing.assert_allclose(t_outs[i].detach().float().numpy(), np.asarray(j_outs[i], np.float32),
                                   rtol=tol["rtol"], atol=tol["atol"], err_msg=f"{size} {kind} output {i}")
    if kind == "dyn":
        sample_logits = np.asarray(j_outs[2], np.float32)
    else:
        with torch.no_grad():
            sample_logits = TK._gru_prior(p_t, spec, tx["z"], tx["a"].to(tc), tx["h"])[1].numpy()
    _assert_samples(t_outs[1].detach().float().numpy(), np.asarray(j_outs[1], np.float32), sample_logits, x["g"],
                    tol["margin"])

    if dtype == "float32":
        for k in TK.PARAM_KEYS:
            ref = np.asarray(j_grads[0][k], np.float32)
            if p_t[k].grad is None:  # imagination: the representation branch is untouched
                assert kind == "imag" and not np.any(ref), k
                continue
            _assert_grad(k, _to_jax_layout(p_t[k].grad), ref, tol["rtol"])
        for k, g_j in zip(diff, j_grads[1:]):
            _assert_grad(k, tx[k].grad.float().numpy(), np.asarray(g_j, np.float32), tol["rtol"])
