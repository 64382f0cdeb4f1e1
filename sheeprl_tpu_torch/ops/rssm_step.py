"""Fused RSSM step: LayerNorm-GRU + prior/posterior heads + straight-through sample.

PyTorch counterpart of ``sheeprl_tpu/ops/pallas/rssm_step.py``. One call of
:func:`rssm_dyn_step` is one step of the world model's dynamic scan (the TPU
kernel ``_dyn_kernel``); one call of :func:`rssm_imag_step` is one imagination
step (``_imag_kernel``). Each wrapper has two implementations of the same math:

- on a CUDA tensor, the hand-written Hopper kernel in ``csrc/rssm_step.cu``
  (built at first use by :mod:`._build`), or an exception: no fallback;
- on a CPU tensor, the plain PyTorch version (:func:`dyn_math`,
  :func:`imag_math`), which is also what the CPU tests compare with JAX.

Precision policy (the f32 islands): matmuls and gate algebra run in the
compute dtype, every product rounded to it as the plain version rounds;
LayerNorm statistics, the softmax / log of the uniform mixture and the returned
logits are float32.

Gradients: :class:`DynStep` and :class:`ImagStep` keep the step *inputs* as
their only residuals (as ``custom_vjp`` does in the JAX package) and recompute
the plain version under autograd in ``backward``. The straight-through sample is
``one_hot + probs - probs.detach()``, so autograd's gradient equals the JAX
hand-written backward's.

Parameters travel as a flat dict keyed by :data:`PARAM_KEYS`. Matrices keep
PyTorch's ``Linear`` orientation ``[out, in]`` (the transpose of the JAX dict),
and the two-operand products ``[x1, x2] @ [W1; W2]`` are column slices of one
``Linear`` weight, so nothing is concatenated. :func:`compute_params` repacks
each slice into its own contiguous, 16-byte aligned matrix once per scan or
horizon, which the kernels' 16-byte loads need.

Kernel layout: :func:`rssm_dyn_step` is one cooperative launch whose split-K
plan comes from :func:`dyn_plan`; :func:`rssm_imag_step` is eight launches
(:data:`DEVICE_LAUNCHES_PER_CALL`). :func:`check_kernel_shapes` names the width
that the kernels' tensor-core products or the card's shared memory per block
(:func:`smem_floats`) cannot take.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.ops import _build

__all__ = [
    "DEVICE_LAUNCHES_PER_CALL",
    "DynPlan",
    "DynStep",
    "ImagStep",
    "KernelUnsupported",
    "LAUNCHES",
    "PARAM_KEYS",
    "RSSMStepSpec",
    "check_kernel_shapes",
    "compute_params",
    "dyn_math",
    "dyn_plan",
    "dyn_smem_bytes",
    "extract_step_params",
    "fused_dynamic_scan",
    "fused_imagination_step",
    "imag_math",
    "initial_step_states",
    "rssm_dyn_step",
    "rssm_imag_step",
    "smem_floats",
]


class KernelUnsupported(Exception):
    """The RSSM's structure or configuration falls outside the fused-step
    contract. Raised to the caller: nothing falls back."""


#: fixed parameter ordering, shared with the CUDA entry points.
PARAM_KEYS = (
    "wi_z", "wi_a", "ln_i_scale", "ln_i_bias",
    "wg_h", "wg_f", "ln_g_scale", "ln_g_bias",
    "wt", "ln_t_scale", "ln_t_bias", "wt_head", "bt_head",
    "wr_h", "wr_e", "ln_r_scale", "ln_r_bias", "wr_head", "br_head",
)
#: matrices, in the order of their leading dimensions in the CUDA ``dims`` array
_MATRIX_KEYS = ("wi_z", "wi_a", "wg_h", "wg_f", "wt", "wt_head", "wr_h", "wr_e", "wr_head")
#: the parameters an imagination step reads (no representation branch)
_IMAG_KEYS = PARAM_KEYS[:13]
#: LayerNorm parameters stay float32 in every precision (the f32 island)
_F32_KEYS = frozenset(k for k in PARAM_KEYS if k.startswith("ln_"))

#: kernel launches by wrapper name; each wrapper adds one where it launches its
#: CUDA entry point and nowhere else
LAUNCHES: Dict[str, int] = {"rssm_dyn_step": 0, "rssm_imag_step": 0}
#: device kernels one wrapper call launches: the dynamic step is one cooperative
#: launch; the imagination step four tile products, three LayerNorm row passes
#: and one unimix/sample pass
DEVICE_LAUNCHES_PER_CALL: Dict[str, int] = {"rssm_dyn_step": 1, "rssm_imag_step": 8}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class RSSMStepSpec:
    """Static description of one fused step (twin of the JAX ``RSSMStepSpec``)."""

    action_size: int
    embed_size: int
    dense_units: int      # RecurrentModel projection width (GRU input)
    recurrent_size: int
    trans_hidden: int     # transition (prior) trunk width
    repr_hidden: int      # representation (posterior) trunk width
    stochastic: int
    discrete: int
    unimix: float
    eps_in: float
    eps_gru: float
    eps_trans: float
    eps_repr: float
    dtype: str = "float32"  # compute dtype name; parameters are always float32

    @property
    def stoch_flat(self) -> int:
        return self.stochastic * self.discrete

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #


def extract_step_params(rssm) -> Dict[str, torch.Tensor]:
    """The port's RSSM modules -> the flat :data:`PARAM_KEYS` dict.

    Values are views of the modules' parameters, so gradients reach them.
    Raises :class:`KernelUnsupported` naming the field that breaks the contract
    (bias where a LayerNorm is expected, extra trunk layers, ...).
    """
    rec = rssm.recurrent_model
    if len(rec.mlp.linears) != 1 or rec.mlp.head is not None:
        raise KernelUnsupported("recurrent_model.mlp must be a single Linear layer")
    if rec.mlp.linears[0].bias is not None or getattr(rec.mlp.norms[0], "weight", None) is None:
        raise KernelUnsupported("recurrent_model.layer_norm: the projection must be Linear without bias + LayerNorm")
    gru = rec.gru
    if gru.bias is not None or gru.ln_weight is None:
        raise KernelUnsupported("recurrent_model.gru must be the Hafner LayerNorm GRU without bias")
    sd = rssm.stochastic_size * rssm.discrete_size
    r = gru.hidden_size
    wi = rec.mlp.linears[0].weight
    wg = gru.weight
    if wi.shape[1] <= sd:
        raise KernelUnsupported(f"recurrent_model input width {wi.shape[1]} cannot split at stoch size {sd}")

    def head(name: str):
        m = getattr(rssm, name)
        if m.mlp is None or len(m.mlp.linears) != 1 or m.mlp.head is not None:
            raise KernelUnsupported(f"{name}.hidden_size: the trunk must be a single hidden layer")
        if m.mlp.linears[0].bias is not None or getattr(m.mlp.norms[0], "weight", None) is None:
            raise KernelUnsupported(f"{name}.layer_norm: the trunk must be Linear without bias + LayerNorm")
        if m.mlp.activation != "silu":
            raise KernelUnsupported(f"{name}.dense_act: the trunk activation must be silu, got {m.mlp.activation!r}")
        ln = m.mlp.norms[0]
        return m.mlp.linears[0].weight, ln.weight, ln.bias, m.head.weight, m.head.bias

    wt, ln_t_scale, ln_t_bias, wt_head, bt_head = head("transition_model")
    wr, ln_r_scale, ln_r_bias, wr_head, br_head = head("representation_model")
    if wr.shape[1] <= r:
        raise KernelUnsupported(f"representation_model input width {wr.shape[1]} cannot split at recurrent size {r}")
    ln_i = rec.mlp.norms[0]
    return {
        "wi_z": wi[:, :sd], "wi_a": wi[:, sd:],
        "ln_i_scale": ln_i.weight, "ln_i_bias": ln_i.bias,
        "wg_h": wg[:, :r], "wg_f": wg[:, r:],
        "ln_g_scale": gru.ln_weight, "ln_g_bias": gru.ln_bias,
        "wt": wt, "ln_t_scale": ln_t_scale, "ln_t_bias": ln_t_bias,
        "wt_head": wt_head, "bt_head": bt_head,
        "wr_h": wr[:, :r], "wr_e": wr[:, r:],
        "ln_r_scale": ln_r_scale, "ln_r_bias": ln_r_bias,
        "wr_head": wr_head, "br_head": br_head,
    }


def compute_params(p32: Dict[str, torch.Tensor], spec: RSSMStepSpec) -> Dict[str, torch.Tensor]:
    """Detached compute-dtype copies of the matrices and head biases, made once
    per scan (LayerNorm parameters stay float32), each matrix repacked into its
    own contiguous buffer: a column slice of a ``Linear`` weight (``wi_z`` of
    ``[DU, S*D + A]``) has a row stride that 16-byte loads refuse. The kernel
    reads these; the gradient still goes to the float32 parameters through the
    Functions."""
    c = spec.compute_dtype
    with torch.no_grad():
        return {k: v.detach() if k in _F32_KEYS else v.detach().to(c).contiguous() for k, v in p32.items()}


# --------------------------------------------------------------------------- #
# plain version (CPU path, reference on the card, backward recompute)
# --------------------------------------------------------------------------- #


def _ln_f32(x_c: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with float32 statistics (twin of ``_ln_f32``)."""
    x32 = x_c.float()
    mu = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale + bias


def _unimix_logits(raw_c: torch.Tensor, spec: RSSMStepSpec) -> torch.Tensor:
    """``[B, S*D]`` head output -> ``[B, S, D]`` float32 log-mixture logits."""
    raw32 = raw_c.float().reshape(*raw_c.shape[:-1], spec.stochastic, spec.discrete)
    if spec.unimix > 0.0:
        q = torch.softmax(raw32, dim=-1)
        return torch.log((1.0 - spec.unimix) * q + spec.unimix / spec.discrete)
    return raw32


def _st_onehot(logits32: torch.Tensor, gumbel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Straight-through sample ``one_hot(argmax(logits + g)) + probs - probs.detach()``;
    the forward value is exactly the one-hot."""
    idx = torch.argmax(logits32 + gumbel, dim=-1)
    hard = F.one_hot(idx, logits32.shape[-1]).to(logits32.dtype)
    probs = torch.softmax(logits32, dim=-1)
    return (hard + (probs - probs.detach())).to(dtype)


def _linear2(x1, w1, x2, w2, c):
    return F.linear(x1, w1.to(c)) + F.linear(x2, w2.to(c))


def _gru_prior(p, spec: RSSMStepSpec, z0, a_m, h0):
    """Input projection, Hafner LN-GRU and prior trunk, shared by both steps."""
    c = spec.compute_dtype
    feat = _ln_f32(_linear2(z0, p["wi_z"], a_m, p["wi_a"], c), p["ln_i_scale"], p["ln_i_bias"], spec.eps_in).to(c)
    gates = _ln_f32(_linear2(h0, p["wg_h"], feat, p["wg_f"], c), p["ln_g_scale"], p["ln_g_bias"], spec.eps_gru).to(c)
    r_pre, c_pre, u_pre = torch.chunk(gates, 3, dim=-1)
    r = torch.sigmoid(r_pre)
    cand = torch.tanh(r * c_pre)
    u = torch.sigmoid(u_pre - 1.0)
    h_new = u * cand + (1.0 - u) * h0
    p_ln = _ln_f32(F.linear(h_new, p["wt"].to(c)), p["ln_t_scale"], p["ln_t_bias"], spec.eps_trans).to(c)
    prior_raw = F.linear(F.silu(p_ln), p["wt_head"].to(c)) + p["bt_head"].to(c)
    return h_new, _unimix_logits(prior_raw, spec)


def dyn_math(p, spec: RSSMStepSpec, init_h, init_z, h, z, a, e, f, g):
    """One dynamic step (twin of ``_dyn_math``): returns
    ``(h_new [B,R], z_new [B,S*D], post_logits [B,S,D] f32, prior_logits [B,S,D] f32)``."""
    c = spec.compute_dtype
    with torch.autocast(device_type=h.device.type, enabled=False):
        f_c = f.to(c)
        a_m = (1.0 - f_c) * a.to(c)
        h0 = (1.0 - f_c) * h.to(c) + f_c * init_h.to(c)
        z0 = (1.0 - f_c) * z.to(c) + f_c * init_z.to(c)
        h_new, prior_logits = _gru_prior(p, spec, z0, a_m, h0)
        q_ln = _ln_f32(_linear2(h_new, p["wr_h"], e.to(c), p["wr_e"], c), p["ln_r_scale"], p["ln_r_bias"], spec.eps_repr)
        post_raw = F.linear(F.silu(q_ln.to(c)), p["wr_head"].to(c)) + p["br_head"].to(c)
        post_logits = _unimix_logits(post_raw, spec)
        z_new = _st_onehot(post_logits, g, c).reshape(h.shape[0], spec.stoch_flat)
    return h_new, z_new, post_logits, prior_logits


def imag_math(p, spec: RSSMStepSpec, h, z, a, g):
    """One imagination step (twin of ``_imag_math``): returns ``(h_new, z_new)``,
    the sample drawn from the prior."""
    c = spec.compute_dtype
    with torch.autocast(device_type=h.device.type, enabled=False):
        h_new, prior_logits = _gru_prior(p, spec, z.to(c), a.to(c), h.to(c))
        z_new = _st_onehot(prior_logits, g, c).reshape(h.shape[0], spec.stoch_flat)
    return h_new, z_new


# --------------------------------------------------------------------------- #
# wrappers: the CUDA kernel for a CUDA tensor, the plain version for a CPU one
# --------------------------------------------------------------------------- #


def _pointer_array(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _param_shapes(spec: RSSMStepSpec) -> Dict[str, Tuple[int, ...]]:
    DU, R, HT, HR, SD = spec.dense_units, spec.recurrent_size, spec.trans_hidden, spec.repr_hidden, spec.stoch_flat
    return {
        "wi_z": (DU, SD), "wi_a": (DU, spec.action_size), "ln_i_scale": (DU,), "ln_i_bias": (DU,),
        "wg_h": (3 * R, R), "wg_f": (3 * R, DU), "ln_g_scale": (3 * R,), "ln_g_bias": (3 * R,),
        "wt": (HT, R), "ln_t_scale": (HT,), "ln_t_bias": (HT,), "wt_head": (SD, HT), "bt_head": (SD,),
        "wr_h": (HR, R), "wr_e": (HR, spec.embed_size), "ln_r_scale": (HR,), "ln_r_bias": (HR,),
        "wr_head": (SD, HR), "br_head": (SD,),
    }


#: the tensor-core product halves of a dynamic step, in the order of the CUDA
#: source's ``H_*`` slots: (weight key, spec field of K, spec field of N)
DYN_HALVES = (
    ("wi_z", "stoch_flat", "dense_units"), ("wg_h", "recurrent_size", "gru_width"),
    ("wg_f", "dense_units", "gru_width"), ("wt", "recurrent_size", "trans_hidden"),
    ("wt_head", "trans_hidden", "stoch_flat"), ("wr_h", "recurrent_size", "repr_hidden"),
    ("wr_e", "embed_size", "repr_hidden"), ("wr_head", "repr_hidden", "stoch_flat"),
)
#: the K widths each entry point reads through 16-byte tensor-core loads
_KERNEL_K_FIELDS = {
    "imag": ("stoch_flat", "recurrent_size", "dense_units", "trans_hidden"),
    "dyn": ("stoch_flat", "recurrent_size", "dense_units", "trans_hidden", "repr_hidden", "embed_size"),
}
#: activations that a kernel reads with 16-byte loads (the action is a rank update)
_ALIGNED_ACTS = frozenset({"init_h", "init_z", "h", "z", "e"})
#: warps of one block of the dynamic step's cooperative launch (``kDynWarps`` of
#: the CUDA source); the plan reads it only to aim the split, not for layout
DYN_BLOCK_WARPS = 16


def _width(spec: RSSMStepSpec, field: str) -> int:
    return 3 * spec.recurrent_size if field == "gru_width" else getattr(spec, field)


def check_kernel_shapes(spec: RSSMStepSpec, kind: str, smem_limit: int) -> None:
    """Raise :class:`KernelUnsupported` naming the first width that the ``kind``
    (``"dyn"`` or ``"imag"``) kernel cannot take: every K width of a product
    streams as 16-byte vectors of the compute dtype, so it is a multiple of 8.
    The action width is free (a rank update on CUDA cores). Then the widths
    whose row passes outgrow ``smem_limit``, the card's opt-in shared memory
    per block in bytes (:func:`smem_floats`)."""
    for field in _KERNEL_K_FIELDS[kind]:
        width = _width(spec, field)
        if width <= 0 or width % 8:
            raise KernelUnsupported(f"{field}={width}: the CUDA RSSM step needs every product's input width "
                                    "to be a positive multiple of 8")
    # dynamic shared memory plus the block reduction buffer, widest pass first
    for field, floats in sorted(smem_floats(spec, kind).items(), key=lambda kv: -kv[1]):
        need = 4 * (floats + SMEM_RED_FLOATS)
        if need > smem_limit:
            raise KernelUnsupported(
                f"{field}={getattr(spec, field)}: a block of the CUDA RSSM {kind} step's row pass needs {need} bytes "
                f"of shared memory, more than the card's {smem_limit} bytes per block")


#: lanes of one categorical in the unimix / sample passes (``kCatLanes``)
CAT_LANES = 8
#: threads of a block of the imagination step's unimix pass (``unimix_rows``)
UNIMIX_THREADS = 256
#: static shared memory of a row-pass block: the 32-float block reduction (``red``)
SMEM_RED_FLOATS = 32


def smem_floats(spec: RSSMStepSpec, kind: str) -> Dict[str, int]:
    """Dynamic shared memory, in floats, that the widest block of each row pass
    of the ``kind`` kernel holds, keyed by the spec field that sets it.

    ``dyn`` (one block size for the whole cooperative launch): the input
    projection's row and its partial sums (2 DU), the GRU's row, h0 and both
    halves' sums (3R + R + 3R + 3R = 10 R), the prior trunk (2 HT), the
    posterior trunk's row and two sums (3 HR), and 64 categoricals of D at
    once (``kDynThreads / kCatLanes``). ``imag`` (one launch per pass): the
    LayerNorm rows DU and HT, the GRU row and h0 (3R + R), and the unimix pass's
    32 categoricals. ``dyn_step`` reads the ``dyn`` size from ``dims``;
    ``layer_norm`` and ``imag_step`` in ``csrc/rssm_step.cu`` size their
    launches by the ``imag`` formulas above: keep both in step."""
    DU, R, HT, HR, D = spec.dense_units, spec.recurrent_size, spec.trans_hidden, spec.repr_hidden, spec.discrete
    if kind == "dyn":
        return {"dense_units": 2 * DU, "recurrent_size": 10 * R, "trans_hidden": 2 * HT, "repr_hidden": 3 * HR,
                "discrete": DYN_BLOCK_WARPS * 32 // CAT_LANES * D}
    return {"dense_units": DU, "recurrent_size": 4 * R, "trans_hidden": HT,
            "discrete": UNIMIX_THREADS // CAT_LANES * D}


def dyn_smem_bytes(spec: RSSMStepSpec) -> int:
    """Dynamic shared memory of one block of the dynamic step's launch."""
    return 4 * max(smem_floats(spec, "dyn").values())


@dataclasses.dataclass(frozen=True)
class DynPlan:
    """Split-K plan of the dynamic step's cooperative launch, per product half
    in :data:`DYN_HALVES` order: ``kc`` is the K chunk of one warp unit (16 rows
    x 8 columns), ``splits`` the chunks per row, ``part_off`` where the half's
    ``[splits, B, N]`` float32 partial sums start in the workspace of
    ``workspace`` floats. The kernel reads all of it and derives none."""

    grid: int
    kc: Tuple[int, ...]
    splits: Tuple[int, ...]
    part_off: Tuple[int, ...]
    workspace: int


@functools.lru_cache(maxsize=None)
def dyn_plan(spec: RSSMStepSpec, batch: int, n_sms: int) -> DynPlan:
    """One block per SM; each half gets about half a unit per warp of the grid
    (two halves share most phases), so that every product streams its weights
    through every SM, with K chunks of whole 32-wide steps."""
    target = n_sms * DYN_BLOCK_WARPS // 2
    mt = -(-batch // 16)
    kc, splits, part_off, workspace = [], [], [], 0
    for _, k_field, n_field in DYN_HALVES:
        K, N = _width(spec, k_field), _width(spec, n_field)
        want = max(1, round(target / (mt * -(-N // 8))))
        chunk = max(32, 32 * math.ceil(K / want / 32))
        n_split = -(-K // chunk)
        kc.append(chunk)
        splits.append(n_split)
        part_off.append(workspace)
        workspace += n_split * batch * N
    if workspace >= 2**31:
        raise KernelUnsupported(f"batch={batch}: the dynamic step's split-K workspace of {workspace} floats "
                                "outgrows the kernel's 32-bit offsets")
    return DynPlan(n_sms, tuple(kc), tuple(splits), tuple(part_off), workspace)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _smem_limit(device_index: int) -> int:
    """The card's opt-in shared memory per block, in bytes
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``), queried once per device."""
    return _build.smem_optin(device_index)


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _check_operands(spec: RSSMStepSpec, pc: Dict[str, torch.Tensor], acts, keys: Sequence[str]):
    """Raise unless every parameter in ``keys`` and every activation has the
    device, dtype, shape and layout the CUDA entry point reads: matrices and the
    activations of :data:`_ALIGNED_ACTS` contiguous and 16-byte aligned."""
    c = spec.compute_dtype
    if c not in _DTYPE_CODES:
        raise TypeError(f"the CUDA RSSM step takes float32 or bfloat16 compute, got {c}")
    device = next(iter(acts.values()))[0].device
    shapes = _param_shapes(spec)
    for k in keys:
        t = pc[k]
        want = torch.float32 if k in _F32_KEYS else c
        if t.device != device or t.dtype != want or tuple(t.shape) != shapes[k]:
            raise ValueError(f"parameter {k}: expected {want} {shapes[k]} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"parameter {k} must have a unit stride along its input dimension")
        if k in _MATRIX_KEYS and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"parameter {k} must be contiguous and 16-byte aligned (compute_params repacks it)")
    for name, (t, shape, dtype) in acts.items():
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {dtype} {shape} on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if name in _ALIGNED_ACTS and t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads it with 16-byte loads, its data must be 16-byte aligned")


def _dims(spec: RSSMStepSpec, batch: int, pc, plan: Optional[DynPlan] = None) -> ctypes.Array:
    vals = [batch, spec.action_size, spec.embed_size, spec.dense_units, spec.recurrent_size,
            spec.trans_hidden, spec.repr_hidden, spec.stochastic, spec.discrete]
    vals += [pc[k].stride(0) for k in _MATRIX_KEYS]
    if plan is not None:
        vals += [plan.grid, *plan.kc, *plan.splits, *plan.part_off, dyn_smem_bytes(spec)]
    else:  # the imagination step reads no plan
        vals += [0] * (2 + 3 * len(DYN_HALVES))
    return (ctypes.c_int * len(vals))(*vals)


def _scalars(spec: RSSMStepSpec) -> ctypes.Array:
    vals = [spec.eps_in, spec.eps_gru, spec.eps_trans, spec.eps_repr,
            1.0 - spec.unimix, spec.unimix / spec.discrete, spec.unimix]
    return (ctypes.c_float * len(vals))(*vals)


def _raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: error {rc} ({_build.error_string(rc)}) at launch")


def rssm_dyn_step(spec: RSSMStepSpec, pc, init_h, init_z, h, z, a, e, f, g):
    """One dynamic step (replaces ``_dyn_kernel``). ``pc`` holds the
    compute-dtype parameters of :func:`compute_params`."""
    if h.device.type == "cpu":
        return dyn_math(pc, spec, init_h, init_z, h, z, a, e, f, g)
    if h.device.type != "cuda":
        raise RuntimeError(f"rssm_dyn_step runs on CUDA or CPU tensors, got {h.device}")
    check_kernel_shapes(spec, "dyn", _smem_limit(_device_index(h)))
    c = spec.compute_dtype
    B, R, SD, S, D = h.shape[0], spec.recurrent_size, spec.stoch_flat, spec.stochastic, spec.discrete
    ins = [t.to(c).contiguous() for t in (init_h, init_z, h, z, a, e)]
    f32 = f.float().contiguous()
    g32 = g.float().contiguous()
    _check_operands(spec, pc, {
        "init_h": (ins[0], (B, R), c), "init_z": (ins[1], (B, SD), c), "h": (ins[2], (B, R), c),
        "z": (ins[3], (B, SD), c), "a": (ins[4], (B, spec.action_size), c),
        "e": (ins[5], (B, spec.embed_size), c), "f": (f32, (B, 1), torch.float32),
        "g": (g32, (B, S, D), torch.float32),
    }, PARAM_KEYS)
    new = lambda *shape, dtype=c: torch.empty(shape, dtype=dtype, device=h.device)  # noqa: E731
    outs = [new(B, R), new(B, SD), new(B, S, D, dtype=torch.float32), new(B, S, D, dtype=torch.float32)]
    plan = dyn_plan(spec, B, _sm_count(_device_index(h)))
    DU, HT, HR, A = spec.dense_units, spec.trans_hidden, spec.repr_hidden, spec.action_size
    # h0 z0 am feat pact qact, then the split-K partial sums
    scratch = [new(B, R), new(B, SD), new(B, A), new(B, DU), new(B, HT), new(B, HR),
               new(plan.workspace, dtype=torch.float32)]
    ptrs = _pointer_array([pc[k] for k in PARAM_KEYS] + ins + [f32, g32] + outs + scratch)
    lib = _build.load()
    rc = lib.rssm_dyn_step(_DTYPE_CODES[c], ptrs, _dims(spec, B, pc, plan), _scalars(spec),
                           ctypes.c_void_p(torch.cuda.current_stream(h.device).cuda_stream))
    _raise_on_error("rssm_dyn_step", rc)
    LAUNCHES["rssm_dyn_step"] += 1
    return tuple(outs)


def rssm_imag_step(spec: RSSMStepSpec, pc, h, z, a, g):
    """One imagination step (replaces ``_imag_kernel``)."""
    if h.device.type == "cpu":
        return imag_math(pc, spec, h, z, a, g)
    if h.device.type != "cuda":
        raise RuntimeError(f"rssm_imag_step runs on CUDA or CPU tensors, got {h.device}")
    check_kernel_shapes(spec, "imag", _smem_limit(_device_index(h)))
    c = spec.compute_dtype
    B, R, SD, S, D = h.shape[0], spec.recurrent_size, spec.stoch_flat, spec.stochastic, spec.discrete
    ins = [t.to(c).contiguous() for t in (h, z, a)]
    g32 = g.float().contiguous()
    _check_operands(spec, pc, {
        "h": (ins[0], (B, R), c), "z": (ins[1], (B, SD), c), "a": (ins[2], (B, spec.action_size), c),
        "g": (g32, (B, S, D), torch.float32),
    }, _IMAG_KEYS)
    new = lambda *shape: torch.empty(shape, dtype=c, device=h.device)  # noqa: E731
    outs = [new(B, R), new(B, SD)]
    DU, HT = spec.dense_units, spec.trans_hidden
    scratch = [new(B, DU), new(B, DU), new(B, 3 * R), new(B, HT), new(B, HT), new(B, SD)]
    ptrs = _pointer_array([pc[k] for k in PARAM_KEYS] + ins + [g32] + outs + scratch)
    lib = _build.load()
    rc = lib.rssm_imag_step(_DTYPE_CODES[c], ptrs, _dims(spec, B, pc), _scalars(spec),
                            ctypes.c_void_p(torch.cuda.current_stream(h.device).cuda_stream))
    _raise_on_error("rssm_imag_step", rc)
    LAUNCHES["rssm_imag_step"] += 1
    return tuple(outs)


# --------------------------------------------------------------------------- #
# autograd: residuals are the step inputs, backward recomputes the plain version
# --------------------------------------------------------------------------- #


def _recompute_grads(ctx, math_fn, spec, n_inputs: int, cotangents):
    saved = ctx.saved_tensors
    inputs, params = saved[:n_inputs], saved[n_inputs:]
    offset = ctx.grad_offset
    needs = ctx.needs_input_grad[offset:]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need) for t, need in zip(inputs + params, needs)]
        p = dict(zip(PARAM_KEYS, leaves[n_inputs:]))
        outs = math_fn(p, spec, *leaves[:n_inputs])
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(outs, wanted, cotangents, allow_unused=True) if wanted else ())
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


class DynStep(torch.autograd.Function):
    """Dynamic step with the input-only residual set of ``_fused_step``.
    ``apply(spec, pc, init_h, init_z, h, z, a, e, f, g, *p32)``; ``f`` and the
    Gumbel field ``g`` are data and get no gradient."""

    @staticmethod
    def forward(ctx, spec, pc, init_h, init_z, h, z, a, e, f, g, *p32):
        ctx.spec = spec
        ctx.grad_offset = 2
        ctx.save_for_backward(init_h, init_z, h, z, a, e, f, g, *p32)
        return rssm_dyn_step(spec, pc, init_h, init_z, h, z, a, e, f, g)

    @staticmethod
    def backward(ctx, dh, dz, dpost, dprior):
        grads = _recompute_grads(ctx, dyn_math, ctx.spec, 8, (dh, dz, dpost, dprior))
        return (None, None) + grads[:6] + (None, None) + grads[8:]


class ImagStep(torch.autograd.Function):
    """Imagination step with the input-only residual set of ``_fused_imag_step``.
    ``apply(spec, pc, h, z, a, g, *p32)``."""

    @staticmethod
    def forward(ctx, spec, pc, h, z, a, g, *p32):
        ctx.spec = spec
        ctx.grad_offset = 2
        ctx.save_for_backward(h, z, a, g, *p32)
        return rssm_imag_step(spec, pc, h, z, a, g)

    @staticmethod
    def backward(ctx, dh, dz):
        grads = _recompute_grads(ctx, imag_math, ctx.spec, 4, (dh, dz))
        return (None, None) + grads[:3] + (None,) + grads[4:]


# --------------------------------------------------------------------------- #
# scan-level entry points
# --------------------------------------------------------------------------- #


def initial_step_states(p, spec: RSSMStepSpec, init_raw: torch.Tensor, batch: int, learnable: bool = True):
    """The learned reset state, computed once per scan (twin of
    ``initial_step_states``): ``(init_h [B,R], init_z [B,S*D])``, the prior's
    mode carrying no gradient."""
    c = spec.compute_dtype
    if not learnable:
        init_raw = init_raw.detach()
    with torch.autocast(device_type=init_raw.device.type, enabled=False):
        init_h = torch.tanh(init_raw).to(c).reshape(1, -1).expand(batch, spec.recurrent_size)
        p_ln = _ln_f32(F.linear(init_h, p["wt"].to(c)), p["ln_t_scale"], p["ln_t_bias"], spec.eps_trans).to(c)
        raw = F.linear(F.silu(p_ln), p["wt_head"].to(c)) + p["bt_head"].to(c)
        logits = _unimix_logits(raw, spec)
        init_z = F.one_hot(logits.argmax(dim=-1), spec.discrete).to(c).reshape(batch, spec.stoch_flat)
    return init_h, init_z.detach()


def fused_dynamic_scan(
    p32: Dict[str, torch.Tensor],
    spec: RSSMStepSpec,
    init_raw: torch.Tensor,
    embedded_obs: torch.Tensor,  # [T, B, E]
    actions: torch.Tensor,       # [T, B, A]
    is_first: torch.Tensor,      # [T, B, 1]
    gumbel: torch.Tensor,        # [T, B, S, D] float32, drawn by the caller
    learnable_init: bool = True,
    custom_grad: bool = True,
):
    """Fused ``RSSM.dynamic_scan`` (non-decoupled): returns
    ``(recurrent_states [T,B,R], posteriors [T,B,S,D], priors_logits, posteriors_logits)``,
    logits float32, states and samples in the compute dtype.

    ``custom_grad=False`` runs the same formulation under plain autograd (the
    ``reference`` setting, CPU tensors only)."""
    T, B = embedded_obs.shape[:2]
    c = spec.compute_dtype
    init_h, init_z = initial_step_states(p32, spec, init_raw, B, learnable=learnable_init)
    h = torch.zeros(B, spec.recurrent_size, dtype=c, device=embedded_obs.device)
    z = torch.zeros(B, spec.stoch_flat, dtype=c, device=embedded_obs.device)
    pc = compute_params(p32, spec) if custom_grad else p32
    p_values = [p32[k] for k in PARAM_KEYS]
    hs, zs, posts, priors = [], [], [], []
    for t in range(T):
        args = (init_h, init_z, h, z, actions[t], embedded_obs[t], is_first[t], gumbel[t])
        if custom_grad:
            h, z, post_l, prior_l = DynStep.apply(spec, pc, *args, *p_values)
        else:
            h, z, post_l, prior_l = dyn_math(p32, spec, *args)
        hs.append(h)
        zs.append(z.reshape(B, spec.stochastic, spec.discrete))
        posts.append(post_l)
        priors.append(prior_l)
    return torch.stack(hs), torch.stack(zs), torch.stack(priors), torch.stack(posts)


def fused_imagination_step(
    p32: Dict[str, torch.Tensor],
    spec: RSSMStepSpec,
    prior_flat: torch.Tensor,
    recurrent_state: torch.Tensor,
    actions: torch.Tensor,
    gumbel: torch.Tensor,  # [B, S, D] float32
    pc: Optional[Dict[str, torch.Tensor]] = None,
    custom_grad: bool = True,
):
    """Fused ``RSSM.imagination_step``: ``(imagined_prior [B,S*D], recurrent_state [B,R])``.
    ``pc`` may carry compute-dtype parameters cast once for the whole horizon."""
    if custom_grad:
        pc = compute_params(p32, spec) if pc is None else pc
        h_new, z_new = ImagStep.apply(spec, pc, recurrent_state, prior_flat, actions, gumbel,
                                      *[p32[k] for k in PARAM_KEYS])
    else:
        h_new, z_new = imag_math(p32, spec, recurrent_state, prior_flat, actions, gumbel)
    return z_new.reshape(prior_flat.shape), h_new

