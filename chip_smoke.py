"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --profile       # also: torch.profiler over one DV3-S gradient step
    python3 chip_smoke.py --profile=XL    # ... over one gradient step of another size preset
    python3 chip_smoke.py --profile=DAP   # ... over one DAP-S (Dream-and-Ponder, float32) gradient step

Phases, each of which raises (exit code != 0) when it fails:

1. the card's name and power limit, as nvidia-smi reports them;
2. build the CUDA RSSM kernels from the sources in the checkout (nvcc, sm_90a);
3. for both kernels, at the widths of every DreamerV3 size preset (XS, S, M,
   L, XL: :data:`SIZES`) and the main path's batches (dyn B=16, imag B=1024),
   plus ragged batches at S and XL (B=17 dyn, B=1000 imag: the masked edges of
   the tiles) and the Dream-and-Ponder imagination batch at S and XL (B=3072,
   the ponder branches folded into the batch, and the ragged 3000), in
   float32 and bfloat16: the kernel against its plain PyTorch version on the
   same inputs, forward and gradients through the autograd.Function;
4. at every size, time each kernel (median of 30 launches, CUDA events) beside
   its plain version, its bound, max(bytes / 3.35 TB/s, FLOPs / peak: 989
   TFLOP/s in bf16, 67 TFLOP/s in float32), and the step's products alone
   through torch.matmul (``products_library_ms``, a yardstick the port never
   calls); count the device kernels of one wrapper call with torch.profiler
   (``launches_per_call``); one ``timing`` JSON line per kernel and size, bf16
   at the DreamerV3 batches, plus the DAP-S path's own cases (:data:`DAP_TIMING`:
   imag at B=3072 in float32 and bf16, dyn at B=16 in float32);
5. the main paths, each ``python -m sheeprl_tpu_torch exp=dreamer_v3
   algo=dreamer_v3_<size> env=dummy algo.world_model.kernels=auto`` at full
   width and bf16-mixed for a few gradient steps (:data:`MAIN_PATHS`: DV3-S,
   then DV3-XL), every launch counter set to 0 just before each and read just
   after: finite losses, exactly 64 dyn / 15 imag launches per step, seconds
   per gradient step and peak device memory (no checkpoint is written);
   then the DAP-S path (:func:`dap_path`), ``exp=dream_and_ponder`` at its own
   32-true with the same cuts, 12 gradient steps: the same gates, the imag
   kernel at B=3072 and dyn at B=16 in float32 on every launch,
   ``State/expected_ponder_steps`` within [1, 3], and one checkpoint at its end;
6. resume at DV3-S (:func:`resume_phase`), in the temporary directory of the
   phases 5-7, deleted after: run A trains with a checkpoint mid-run and one at its end; its last
   checkpoint must hold run A's live state bitwise (parameters, Adam state,
   moments, counter, ratio, generator, buffer contents and pos/full, the
   buffer's last truncated flags patched in the file and restored in the live
   buffer); the trainer rebuilt from it and run A's trainer take one train
   step on the same batch and generator state, metrics within 2e-2; run B
   resumes from the middle checkpoint through ``cli.run`` and must take the
   JAX loop's count of gradient steps for that resume, with finite losses and
   64 dyn / 15 imag launches per step; save and load seconds and checkpoint
   bytes are printed;
7. evaluation (:func:`eval_phase`): ``python -m sheeprl_tpu_torch.eval
   checkpoint_path=<ckpt>`` in a subprocess on the card, for the DAP-S
   checkpoint and run A's last DV3-S checkpoint: exit code 0, a CUDA device,
   and the CRC32 of the evaluated player's parameters equal to that of the
   file's world model and actor; the reward and the seconds to load and to
   play are printed;
8. the ``kernels`` JSON line (times at the S shapes in bf16, launches summed
   over the main paths, the DAP-S path and runs A and B), the card line, then
   the device JSON line last.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if not os.path.isdir(os.path.join(HERE, "sheeprl_tpu_torch")):
    sys.exit("chip_smoke.py must run from a checkout of the repository (sheeprl_tpu_torch/ is missing)")
sys.path.insert(0, HERE)

import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")

from sheeprl_tpu_torch.ops import _build  # noqa: E402
from sheeprl_tpu_torch.ops import rssm_step as K  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, NVIDIA data sheet
# float32 outside the tensor cores, NVIDIA data sheet (H100 SXM): the kernels'
# float32 path multiplies on CUDA cores and never uses TF32
FP32_FLOPS = 67e12



def _size(dense_units: int, recurrent: int, cnn_mult: int) -> dict:
    # 64x64 rgb on discrete_dummy (action_dim 2): the 4-stage CNN encoder gives
    # 8 * multiplier * 4 * 4 features; HT = HR = DU in every preset
    return dict(A=2, E=8 * cnn_mult * 16, DU=dense_units, R=recurrent, HT=dense_units, HR=dense_units, S=32, D=32)


#: the RSSM widths of the DreamerV3 presets (configs/algo/dreamer_v3_<size>.yaml)
SIZES = {"XS": _size(256, 256, 24), "S": _size(512, 512, 32), "M": _size(640, 1024, 48),
         "L": _size(768, 2048, 64), "XL": _size(1024, 4096, 96)}
DYN_B = 16  # per_rank_batch_size
IMAG_B = 16 * 64  # batch x sequence: every posterior starts an imagined trajectory
RAGGED_B = {"dyn": 17, "imag": 1000}  # batches that end inside a tile
RAGGED_SIZES = ("S", "XL")
#: Dream-and-Ponder folds its 3 ponder branches into the imagination batch:
#: max_ponder_steps x sequence x batch rows, and a ragged batch beside it
DAP_IMAG_B, DAP_RAGGED_B = 3 * IMAG_B, 3000
#: the DAP-S path's kernel cases that get a timing line: (kind, dtype, batch) at S widths
DAP_TIMING = (("imag", "float32", DAP_IMAG_B), ("imag", "bfloat16", DAP_IMAG_B), ("dyn", "float32", DYN_B))
#: size whose kernel times go into the ``kernels`` line (comparable with earlier runs)
KERNELS_LINE_SIZE = "S"
# depth cuts only: 4 envs, a 4096-row replay in memory, no video, no test episode;
# replay ratio 1 and learning_starts=260 give 4 gradient steps a train call from
# the 65th iteration on
_CUTS = ["env.num_envs=4", "env.sync_env=True", "env.capture_video=False", "algo.learning_starts=260",
         "buffer.size=4096", "buffer.memmap=False", "metric.log_every=4", "algo.run_test=False"]
#: (size, total_steps): S takes 12 gradient steps in three train calls, XL 8 in two
MAIN_PATHS = (("S", 268), ("XL", 264))
#: DAP-S: 12 gradient steps in three train calls, a checkpoint at the end
DAP_TOTAL_STEPS, DAP_PONDER_STEPS = 268, 3
#: resume phase at S: run A trains 20 gradient steps (iterations 65-69) and saves
#: at policy step 264 (iteration 66, 8 steps, the Ratio's count at 8) and at its end
RESUME_TOTAL_STEPS, RESUME_EVERY, RESUME_A_STEPS, RESUME_MIDDLE_STEPS = 276, 264, 20, 8
#: run B resumes at iteration 67 with algo.total_steps kept at 540 (135 iterations).
#: As in the JAX loop, a resumed run moves learning_starts and the Ratio's offset by
#: start_iter (to 132 and 131): the policy acts in iterations 67-131, iteration 132
#: re-anchors the Ratio (count 4 against its saved 8) and trains nothing, and
#: iterations 133-135 train 4 steps each
RESUME_B_TOTAL_STEPS, RESUME_B_STEPS = 540, 12
#: train-step equivalence of run A's trainer and the trainer rebuilt from its checkpoint
RESUME_STEP_TOL = 2e-2
TOL = {"float32": dict(rtol=1e-4, atol=1e-5, margin=1e-3), "bfloat16": dict(rtol=2e-2, atol=2e-2, margin=5e-2)}


def log(msg: str) -> None:
    print(msg, flush=True)


def spec_for(size: str, dtype: str) -> K.RSSMStepSpec:
    d = SIZES[size]
    return K.RSSMStepSpec(
        action_size=d["A"], embed_size=d["E"], dense_units=d["DU"], recurrent_size=d["R"],
        trans_hidden=d["HT"], repr_hidden=d["HR"], stochastic=d["S"], discrete=d["D"], unimix=0.01,
        eps_in=1e-3, eps_gru=1e-3, eps_trans=1e-3, eps_repr=1e-3, dtype=dtype,
    )


def random_params(spec: K.RSSMStepSpec, gen: torch.Generator, dev) -> dict:
    A, E, DU, R, HT, HR = (spec.action_size, spec.embed_size, spec.dense_units, spec.recurrent_size,
                           spec.trans_hidden, spec.repr_hidden)
    SD = spec.stoch_flat
    shapes = {"wi": (DU, SD + A), "wg": (3 * R, R + DU), "wt": (HT, R), "wt_head": (SD, HT), "wr": (HR, R + E),
              "wr_head": (SD, HR)}
    w = {k: torch.randn(s, generator=gen, device=dev) / (s[1] ** 0.5) for k, s in shapes.items()}
    ln = lambda n: (1.0 + 0.05 * torch.randn(n, generator=gen, device=dev), 0.05 * torch.randn(n, generator=gen, device=dev))  # noqa: E731
    p = {"wi_z": w["wi"][:, :SD], "wi_a": w["wi"][:, SD:], "wg_h": w["wg"][:, :R], "wg_f": w["wg"][:, R:],
         "wt": w["wt"], "wt_head": w["wt_head"], "wr_h": w["wr"][:, :R], "wr_e": w["wr"][:, R:],
         "wr_head": w["wr_head"],
         "bt_head": 0.01 * torch.randn(SD, generator=gen, device=dev),
         "br_head": 0.01 * torch.randn(SD, generator=gen, device=dev)}
    for key, n in (("i", DU), ("g", 3 * R), ("t", HT), ("r", HR)):
        p[f"ln_{key}_scale"], p[f"ln_{key}_bias"] = ln(n)
    return p


def gumbel(shape, gen, dev):
    u = torch.rand(shape, generator=gen, device=dev).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def dyn_inputs(spec: K.RSSMStepSpec, gen, dev, B):
    R, S, D, A, SD = spec.recurrent_size, spec.stochastic, spec.discrete, spec.action_size, spec.stoch_flat
    one_hot = torch.nn.functional.one_hot
    is_first = (torch.rand(B, 1, generator=gen, device=dev) < 0.25).float()
    return dict(
        init_h=torch.tanh(torch.randn(1, R, generator=gen, device=dev)).expand(B, -1),
        init_z=one_hot(torch.randint(0, D, (B, S), generator=gen, device=dev), D).float().reshape(B, SD),
        h=torch.tanh(torch.randn(B, R, generator=gen, device=dev)),
        z=one_hot(torch.randint(0, D, (B, S), generator=gen, device=dev), D).float().reshape(B, SD),
        a=one_hot(torch.randint(0, A, (B,), generator=gen, device=dev), A).float(),
        e=torch.randn(B, spec.embed_size, generator=gen, device=dev),
        f=is_first,
        g=gumbel((B, S, D), gen, dev),
    )


def imag_inputs(spec: K.RSSMStepSpec, gen, dev, B):
    full = dyn_inputs(spec, gen, dev, B)
    return {k: full[k] for k in ("h", "z", "a", "g")}


def sample_agreement(z_a, z_b, logits, g, margin):
    """Samples must agree wherever the top-2 margin of logits + gumbel exceeds ``margin``."""
    y = (logits.float() + g).reshape(-1, logits.shape[-1])
    top2 = torch.topk(y, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > margin
    za = z_a.float().reshape(-1, logits.shape[-1])
    zb = z_b.float().reshape(-1, logits.shape[-1])
    bad = (za != zb).any(dim=-1) & clear
    return int(bad.sum()), int(clear.sum())


def check_close(name, got, ref, rtol, atol):
    got32, ref32 = got.float(), ref.float()
    err = (got32 - ref32).abs()
    max_abs = float(err.max())
    max_rel = float((err / (ref32.abs() + 1e-12)).max())
    ok = bool(torch.allclose(got32, ref32, rtol=rtol, atol=atol))
    log(f"  {name:<24s} max_abs={max_abs:.3e} max_rel={max_rel:.3e} (rtol={rtol}, atol={atol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version beyond rtol={rtol}, atol={atol}")
    return max_abs


def check_grad(name, got, ref, tol):
    """Gradient agreement, normwise: max|got - ref| <= tol * max|ref|."""
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max()) + 1e-12
    ok = err <= tol * scale
    log(f"  grad {name:<19s} max_abs={err:.3e} rel_to_max={err / scale:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"gradient of {name}: Function path disagrees with plain autograd beyond {tol}")
    return err


def loss_of(outs, weights):
    return sum((o.float() * w).sum() if i else (o.float() ** 2 * w).sum() for i, (o, w) in enumerate(zip(outs, weights)))


def check_kernel(kind: str, dtype: str, dev, B: int, size: str) -> float:
    """Kernel vs plain version at batch ``B`` and the widths of ``size``;
    returns the worst forward abs error."""
    tol = TOL[dtype]
    gen = torch.Generator(device=dev).manual_seed(7)
    spec = spec_for(size, dtype)
    p32 = random_params(spec, gen, dev)
    pc = K.compute_params(p32, spec)
    x = dyn_inputs(spec, gen, dev, B) if kind == "dyn" else imag_inputs(spec, gen, dev, B)
    c = spec.compute_dtype
    x = {k: (v.to(c) if k not in ("f", "g") else v) for k, v in x.items()}
    log(f"[kernel] rssm_{kind}_step {size} {dtype} B={B}")
    with torch.no_grad():
        if kind == "dyn":
            got = K.rssm_dyn_step(spec, pc, *x.values())
            ref = K.dyn_math(pc, spec, *x.values())
        else:
            got = K.rssm_imag_step(spec, pc, *x.values())
            ref = K.imag_math(pc, spec, *x.values())
    torch.cuda.synchronize()
    worst = check_close("h_new", got[0], ref[0], tol["rtol"], tol["atol"])
    if kind == "dyn":
        worst = max(worst, check_close("post_logits", got[2], ref[2], tol["rtol"], tol["atol"]))
        worst = max(worst, check_close("prior_logits", got[3], ref[3], tol["rtol"], tol["atol"]))
        sample_logits = ref[2]
    else:
        p_plain = {k: v for k, v in pc.items()}
        with torch.no_grad():
            _, prior_logits = K._gru_prior(p_plain, spec, x["z"], x["a"], x["h"])
        sample_logits = prior_logits
    bad, clear = sample_agreement(got[1], ref[1], sample_logits, x["g"], tol["margin"])
    log(f"  z_new samples: {bad} of {clear} clear-margin categoricals disagree")
    if bad:
        raise AssertionError(f"rssm_{kind}_step {dtype}: one-hot samples disagree at clear margins")

    # gradients: through the autograd.Function (kernel forward, recompute backward)
    # against plain autograd of the same formulation
    weights = [torch.randn(o.shape, generator=gen, device=dev) for o in ref]
    diff_keys = ["init_h", "init_z", "h", "z", "a", "e"] if kind == "dyn" else ["h", "z", "a"]

    def run(use_function: bool):
        leaves = {k: v.detach().clone().requires_grad_(k in diff_keys) for k, v in x.items()}
        params = {k: v.detach().clone().requires_grad_(True) for k, v in p32.items()}
        if use_function:
            pcc = K.compute_params(params, spec)
            vals = [params[k] for k in K.PARAM_KEYS]
            fn = K.DynStep if kind == "dyn" else K.ImagStep
            outs = fn.apply(spec, pcc, *leaves.values(), *vals)
        else:
            math = K.dyn_math if kind == "dyn" else K.imag_math
            outs = math(params, spec, *leaves.values())
        loss_of(outs, weights).backward()
        return {**{k: leaves[k].grad for k in diff_keys}, **{k: params[k].grad for k in K.PARAM_KEYS}}

    g_fn, g_ref = run(True), run(False)
    torch.cuda.synchronize()
    for k in g_ref:
        if g_ref[k] is None:
            if g_fn[k] is not None and float(g_fn[k].abs().max()) != 0.0:
                raise AssertionError(f"gradient of {k}: plain autograd has none, the Function path does")
            continue
        check_grad(k, g_fn[k], g_ref[k], tol["rtol"])
    return worst


def device_ms(fn, n: int = 30) -> float:
    """Median device time of one call: calls are queued behind a sleep kernel so
    the host's launch overhead does not open gaps between them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda._sleep(50_000_000)
    events[0].record()
    for i in range(n):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    times = sorted(events[i].elapsed_time(events[i + 1]) for i in range(n))
    return times[n // 2]


def step_bound_ms(kind: str, spec: K.RSSMStepSpec, B: int):
    """Least time for one step's work: each input read once, each output written
    once, and the products' operations at the card's peak for the compute
    dtype (dense bf16 tensor cores, or float32 on CUDA cores)."""
    A, E, DU, R, HT, HR, SD = (spec.action_size, spec.embed_size, spec.dense_units, spec.recurrent_size,
                               spec.trans_hidden, spec.repr_hidden, spec.stoch_flat)
    cb = torch.tensor([], dtype=spec.compute_dtype).element_size()
    products = [(SD + A, DU), (R + DU, 3 * R), (R, HT), (HT, SD)]
    ln_params = 2 * (DU + 3 * R + HT)
    head_bias = SD
    if kind == "dyn":
        products += [(R + E, HR), (HR, SD)]
        ln_params += 2 * HR
        head_bias += SD
        act_in = B * (R * 2 + SD * 2 + A + E) * cb + B * 4 + B * SD * 4  # init_h init_z h z a e, f, gumbel
        act_out = B * (R + SD) * cb + 2 * B * SD * 4
    else:
        act_in = B * (R + SD + A) * cb + B * SD * 4
        act_out = B * (R + SD) * cb
    weights = sum(k * n for k, n in products)
    nbytes = weights * cb + head_bias * cb + ln_params * 4 + act_in + act_out
    flops = 2 * B * weights
    peak = BF16_FLOPS if spec.dtype == "bfloat16" else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def device_kernels(cases, gap_s: float = 0.01) -> dict:
    """Names of the device kernels one wrapper call of each case launches, by
    case label: one torch.profiler session over one call of each case in turn
    (on the card, a third session in one process recorded no device events),
    the calls ``gap_s`` apart on an idle device. The kernels are grouped by the
    idle gaps of the device's own timeline, in call order: the offset between
    the host's and the device's clocks in the trace, which once moved a kernel
    into the previous call's host range, cannot move it between groups."""
    from torch.profiler import ProfilerActivity, profile

    for case in cases:
        case["call"]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for case in cases:
            time.sleep(gap_s)
            case["call"]()
            torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    groups, last_end = [], None
    for e in kernels:  # time_range is in microseconds
        if last_end is None or e.time_range.start - last_end > gap_s * 1e6 / 2:
            groups.append([])
        groups[-1].append(e.name)
        last_end = max(e.time_range.end, last_end or e.time_range.end)
    if len(groups) != len(cases):
        raise AssertionError(f"the profiled session shows {len(groups)} groups of device kernels "
                             f"for {len(cases)} wrapper calls")
    return {case["label"]: group for case, group in zip(cases, groups)}


def step_products(kind: str, spec: K.RSSMStepSpec, pc, B: int, gen, dev):
    """The step's products alone, at the kernel's shapes and dtype, through
    torch.matmul (a yardstick for the product part; the port never calls it)."""
    R = spec.recurrent_size
    pairs = [("wi_z", spec.stoch_flat), ("wi_a", spec.action_size), ("wg_h", R), ("wg_f", spec.dense_units),
             ("wt", R), ("wt_head", spec.trans_hidden)]
    if kind == "dyn":
        pairs += [("wr_h", R), ("wr_e", spec.embed_size), ("wr_head", spec.repr_hidden)]
    acts = [torch.randn(B, k, generator=gen, device=dev).to(spec.compute_dtype) for _, k in pairs]
    weights = [pc[key].t() for key, _ in pairs]
    return lambda: [torch.matmul(x, w) for x, w in zip(acts, weights)]


def timing_case(kind: str, dev, size: str, dtype: str = "bfloat16", B: int = None) -> dict:
    """Parameters and inputs of one kernel at the widths of ``size``, in
    ``dtype`` (default bf16, as the DreamerV3 paths run bf16-mixed) and at
    batch ``B`` (default the DreamerV3 main path's), with the wrapper call, its
    plain version and its products through torch.matmul."""
    spec = spec_for(size, dtype)
    gen = torch.Generator(device=dev).manual_seed(11)
    p32 = random_params(spec, gen, dev)
    pc = K.compute_params(p32, spec)
    B = B or (DYN_B if kind == "dyn" else IMAG_B)
    x = dyn_inputs(spec, gen, dev, B) if kind == "dyn" else imag_inputs(spec, gen, dev, B)
    c = spec.compute_dtype
    x = list({k: (v.to(c).contiguous() if k not in ("f", "g") else v) for k, v in x.items()}.values())
    wrapper = K.rssm_dyn_step if kind == "dyn" else K.rssm_imag_step
    plain = K.dyn_math if kind == "dyn" else K.imag_math
    return dict(kind=kind, size=size, B=B, spec=spec, label=f"rssm_{kind}_step/{size}/{dtype}/B{B}",
                call=lambda: wrapper(spec, pc, *x), plain=lambda: plain(pc, spec, *x),
                products=step_products(kind, spec, pc, B, gen, dev))


def time_kernel(case: dict, names) -> tuple:
    """Times of one case's kernel, plain version and products, in turns; prints
    its ``timing`` line."""
    kind, size, B, spec = case["kind"], case["size"], case["B"], case["spec"]
    name = f"rssm_{kind}_step"
    with torch.no_grad():
        t_plain_a = device_ms(case["plain"])
        t_kernel_a = device_ms(case["call"])
        t_lib_a = device_ms(case["products"])
        t_lib_b = device_ms(case["products"])
        t_kernel_b = device_ms(case["call"])
        t_plain_b = device_ms(case["plain"])
    log(f"[time] {name} {size} device kernels of one call: {names}")
    if len(names) != K.DEVICE_LAUNCHES_PER_CALL[name]:
        raise AssertionError(f"{name} {size}: {len(names)} device kernels per call, "
                             f"expected {K.DEVICE_LAUNCHES_PER_CALL[name]}")
    bound, bound_by, nbytes, flops = step_bound_ms(kind, spec, B)
    ms, plain_ms = min(t_kernel_a, t_kernel_b), min(t_plain_a, t_plain_b)
    log(f"[time] {name} {size} {spec.dtype} B={B}: kernel {t_kernel_a:.4f}/{t_kernel_b:.4f} ms, "
        f"plain {t_plain_a:.4f}/{t_plain_b:.4f} ms, products through torch.matmul {t_lib_a:.4f}/{t_lib_b:.4f} ms, "
        f"bound {bound:.4f} ms ({bound_by}; {nbytes} B, {flops} FLOP)")
    print(json.dumps({"timing": name, "size": size, "batch": B, "dtype": spec.dtype, "kernel_ms": [t_kernel_a, t_kernel_b],
                      "plain_ms": [t_plain_a, t_plain_b], "products_library_ms": [t_lib_a, t_lib_b],
                      "launches_per_call": len(names), "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
                      "flops": flops}), flush=True)
    return ms, plain_ms, bound, bound_by


def time_kernels(dev) -> dict:
    """Every kernel at every size in bf16, then the DAP-S cases
    (:data:`DAP_TIMING`); timing launches are not main-path launches, so the
    counters are restored after. Returns the bf16 times by size and kind."""
    saved = dict(K.LAUNCHES)
    cases = [timing_case(kind, dev, size) for size in SIZES for kind in ("dyn", "imag")]
    dap_cases = [timing_case(kind, dev, "S", dtype, B) for kind, dtype, B in DAP_TIMING]
    with torch.no_grad():
        names = device_kernels(cases + dap_cases)
    timings = {size: {} for size in SIZES}
    for case in cases:
        timings[case["size"]][case["kind"]] = time_kernel(case, names[case["label"]])
    for case in dap_cases:
        time_kernel(case, names[case["label"]])
    K.LAUNCHES.update(saved)
    return timings


def main_overrides(size: str, total_steps: int) -> list:
    return ["exp=dreamer_v3", f"algo=dreamer_v3_{size}", "env=dummy", "algo.world_model.kernels=auto",
            *_CUTS, f"algo.total_steps={total_steps}"]


def drive(label: str, overrides) -> tuple:
    """One run of the port's CLI entry, every launch counter set to 0 just
    before and read just after; checks finite losses and 64 dyn / 15 imag
    launches per gradient step. Returns ``(summary, launches)``."""
    from sheeprl_tpu_torch import cli

    log(f"[{label}] python -m sheeprl_tpu_torch {' '.join(overrides)}")
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary = cli.run(overrides)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    steps = summary["gradient_steps"]
    peak = torch.cuda.max_memory_allocated()
    log(f"[{label}] gradient steps {steps}, launches {launches}, run {wall:.1f} s")
    log(f"[{label}] losses per train call: {json.dumps(summary['losses'])}")
    log(f"[{label}] seconds per gradient step (after the first train call): {summary['seconds_per_step']}")
    log(f"[{label}] peak torch.cuda.max_memory_allocated: {peak} bytes")
    if steps < 4:
        raise AssertionError(f"{label} took {steps} gradient steps, expected at least 4")
    for row in summary["losses"]:
        for name, value in row.items():
            if not (value == value and abs(value) != float("inf")):
                raise AssertionError(f"non-finite {name} in {label}: {value}")
    if launches["rssm_dyn_step"] != 64 * steps or launches["rssm_imag_step"] != 15 * steps:
        raise AssertionError(f"{label} launch counts {launches} != 64 and 15 per gradient step x {steps} steps")
    summary["max_memory_allocated"] = peak
    return summary, launches


class BatchSpy:
    """Records ``(batch, dtype)`` of every call of both wrappers while it is
    installed; each call goes on to the wrapper, which counts its launch."""

    def __init__(self):
        self.seen = {"dyn": set(), "imag": set()}
        self._saved = {}

    def __enter__(self):
        for kind in ("dyn", "imag"):
            name = f"rssm_{kind}_step"
            wrapper = self._saved[name] = getattr(K, name)

            def spy(spec, pc, *args, _kind=kind, _wrapper=wrapper):
                h = args[2] if _kind == "dyn" else args[0]
                self.seen[_kind].add((int(h.shape[0]), spec.dtype))
                return _wrapper(spec, pc, *args)

            setattr(K, name, spy)
        return self

    def __exit__(self, *exc):
        for name, wrapper in self._saved.items():
            setattr(K, name, wrapper)


def main_path(size: str, total_steps: int) -> dict:
    """The port's CLI entry at the full width of ``size``, kernels=auto,
    bf16-mixed, saving no checkpoint; returns the launch counts of this run alone."""
    summary, launches = drive(f"main {size}", main_overrides(size, total_steps) + ["checkpoint.save_last=False"])
    print(json.dumps({"main_path": size, "gradient_steps": summary["gradient_steps"], "launches": launches,
                      "seconds_per_step": summary["seconds_per_step"],
                      "max_memory_allocated": summary["max_memory_allocated"], "losses": summary["losses"]}),
          flush=True)
    return launches


def dap_path(work: str) -> tuple:
    """DAP-S through the port's CLI entry at full width, kernels=auto, at the
    exp's 32-true, with the DV3-S cuts and one checkpoint at its end, run in
    ``work``; returns the launch counts of this run and the checkpoint's path."""
    from sheeprl_tpu_torch.utils import checkpoint as ckpt

    overrides = ["exp=dream_and_ponder", "env=dummy", "algo.world_model.kernels=auto", *_CUTS,
                 f"algo.total_steps={DAP_TOTAL_STEPS}", "checkpoint.save_last=True", "run_name=dap_s"]
    cwd = os.getcwd()
    try:
        os.chdir(work)
        with BatchSpy() as spy:
            summary, launches = drive("main DAP-S", overrides)
    finally:
        os.chdir(cwd)
    trainer = summary["live"]["trainer"]
    expected = {"dyn": {(DYN_B, "float32")}, "imag": {(DAP_IMAG_B, "float32")}}
    log(f"[main DAP-S] wrapper calls by (batch, dtype): {spy.seen}")
    if spy.seen != expected or trainer.runtime.precision != "32-true":
        raise AssertionError(f"DAP-S ran the kernels at {spy.seen} under {trainer.runtime.precision}, "
                             f"expected {expected} under 32-true")
    for row in summary["losses"]:
        if not 1.0 <= row["State/expected_ponder_steps"] <= DAP_PONDER_STEPS:
            raise AssertionError(f"State/expected_ponder_steps {row['State/expected_ponder_steps']} outside "
                                 f"[1, {DAP_PONDER_STEPS}]")
    ckpt_dir = os.path.join(work, summary["log_dir"], "checkpoint")
    (path,) = [os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir)]
    if ckpt.ckpt_step(path) != DAP_TOTAL_STEPS or summary["gradient_steps"] != 12:
        raise AssertionError(f"DAP-S took {summary['gradient_steps']} gradient steps and wrote {path}")
    print(json.dumps({"main_path": "DAP-S", "gradient_steps": summary["gradient_steps"], "launches": launches,
                      "precision": trainer.runtime.precision,
                      "wrapper_batches": {k: sorted(v) for k, v in spy.seen.items()},
                      "seconds_per_step": summary["seconds_per_step"],
                      "max_memory_allocated": summary["max_memory_allocated"],
                      "checkpoint_bytes": os.path.getsize(path), "losses": summary["losses"]}), flush=True)
    return launches, path


def eval_phase(checkpoints, card: str) -> None:
    """``python -m sheeprl_tpu_torch.eval checkpoint_path=<ckpt>`` in a
    subprocess on the card for each ``(algorithm, checkpoint)``: exit code 0,
    a CUDA device, and the evaluated parameters' CRC32 equal to the file's
    world model and actor."""
    from sheeprl_tpu_torch.utils import checkpoint as ckpt

    for algo, path in checkpoints:
        cmd = [sys.executable, "-m", "sheeprl_tpu_torch.eval", f"checkpoint_path={path}"]
        log(f"[eval {algo}] {' '.join(cmd[1:])}")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"eval of {path} exited {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
        result = json.loads([line for line in proc.stdout.splitlines() if line.startswith("{")][-1])
        state = ckpt.load_state(path, fallback_to_older=False)
        want = ckpt.tree_crc32({k: state[k] for k in ("world_model", "actor")})
        if result["eval"] != algo or not result["device"].startswith("cuda") or result["params_crc32"] != want:
            raise AssertionError(f"eval of {path}: {result}, expected {algo} on cuda with params_crc32 {want}")
        log(f"[eval {algo}] reward {result['reward']}, load {result['load_seconds']:.3f} s, play "
            f"{result['play_seconds']:.3f} s, process {wall:.1f} s, parameters' CRC32 {want} equal the file's [{card}]")
        print(json.dumps(dict(result, card=card, process_seconds=wall)), flush=True)


def resume_phase(dev, card: str, work: str) -> tuple:
    """Save and resume at DV3-S (phase 6) in ``work``; returns the launch
    counts of runs A and B and run A's last checkpoint."""
    import copy

    import numpy as np

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_NAMES, DV3Trainer
    from sheeprl_tpu_torch.config import compose, instantiate
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.utils import checkpoint as ckpt

    overrides = main_overrides("S", RESUME_TOTAL_STEPS) + [f"checkpoint.every={RESUME_EVERY}",
                                                           "checkpoint.save_last=True"]
    cwd, tmp = os.getcwd(), work
    try:
        os.chdir(tmp)
        run_a, launches_a = drive("resume A", overrides)
        live = run_a["live"]
        trainer_a, rb = live["trainer"], live["rb"]
        if run_a["gradient_steps"] != RESUME_A_STEPS:
            raise AssertionError(f"run A took {run_a['gradient_steps']} gradient steps, expected {RESUME_A_STEPS}")
        ckpt_dir = os.path.join(run_a["log_dir"], "checkpoint")
        paths = sorted((os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir)), key=ckpt.ckpt_step)
        if [ckpt.ckpt_step(p) for p in paths] != [RESUME_EVERY, RESUME_TOTAL_STEPS]:
            raise AssertionError(f"run A wrote {paths}, expected checkpoints at {RESUME_EVERY} and {RESUME_TOTAL_STEPS}")
        middle, last = paths

        # round trip: the last checkpoint holds run A's live state, bitwise
        t0 = time.perf_counter()
        saved = ckpt.load_state(last, fallback_to_older=False)
        read_s = time.perf_counter() - t0
        live_state = trainer_a.state_dict()
        undo = rb._patch_truncated()  # the buffer as the checkpoint callback writes it
        as_saved = copy.deepcopy(rb.state_dict())
        rb._unpatch_truncated(undo)
        n = ckpt.assert_same_tree({k: saved[k] for k in live_state}, live_state, "trainer state")
        n += ckpt.assert_same_tree(saved["rb"], as_saved, "replay buffer")
        ckpt.assert_same_tree(saved["ratio"], live["ratio"].state_dict(), "ratio")
        del as_saved
        if not torch.equal(torch.from_numpy(saved["rng"]["torch"]), live["generator"].get_state()):
            raise AssertionError("the checkpoint's generator state is not run A's")
        if saved["rng"]["rb"] != rb.rng_states() or saved["counter"] != RESUME_A_STEPS:
            raise AssertionError("the checkpoint's sampler states or counter are not run A's")
        log(f"[resume] round trip: {n} arrays bitwise equal to run A's live state, counter {saved['counter']}")

        # the save, timed on run A's live state, leaves the buffer's truncated flags as they were
        before = [np.array(b["buffer"]["truncated"]) for b in rb.state_dict()["buffers"]]
        again = os.path.join(tmp, "timed", "ckpt_again_0.ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = dict(live_state, ratio=live["ratio"].state_dict(), iter_num=saved["iter_num"],
                     batch_size=saved["batch_size"], last_log=saved["last_log"],
                     last_checkpoint=saved["last_checkpoint"], rng=saved["rng"])
        info = ckpt.CheckpointCallback().on_checkpoint_coupled(again, state, rb)
        save_s = time.perf_counter() - t0
        after = [b["buffer"]["truncated"] for b in rb.state_dict()["buffers"]]
        if [x.tobytes() for x in before] != [y.tobytes() for y in after]:  # bitwise: unwritten rows hold any bits
            raise AssertionError("the save left the live buffer's truncated flags patched")

        # train-step equivalence: the trainer rebuilt from the checkpoint against run A's
        cfg = cli.resume_from_checkpoint(compose(overrides + [f"checkpoint.resume_from={last}"]))
        runtime = instantiate(cfg.fabric)
        obs_space = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 64, 64), dtype="uint8")})
        wm, actor, critic, target, _ = build_agent(runtime, [2], False, cfg, obs_space)
        trainer_b = DV3Trainer(wm, actor, critic, target, cfg, runtime, False, [2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer_b.load_state_dict(ckpt.load_state(last, fallback_to_older=False))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n = ckpt.assert_same_tree(trainer_b.state_dict(), live_state, "rebuilt trainer")
        log(f"[resume] rebuilt trainer: {n} arrays bitwise equal to run A's")
        batch = rb.sample(int(cfg.algo.per_rank_batch_size), n_samples=1,
                          sequence_length=int(cfg.algo.per_rank_sequence_length))
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[0])).to(dev) for k, v in batch.items()}
        saved_launches = dict(K.LAUNCHES)
        metrics = []
        for trainer in (trainer_a, trainer_b):
            gen = torch.Generator(device=dev).manual_seed(1234)
            metrics.append(trainer.train_step(batch, gen).float().cpu())
        K.LAUNCHES.update(saved_launches)
        diff = (metrics[0] - metrics[1]).abs()
        rel = diff / metrics[1].abs().clamp_min(1.0)
        worst = int(rel.argmax())
        log(f"[resume] train-step equivalence: largest difference {float(diff.max()):.3e} "
            f"(relative {float(rel.max()):.3e} in {METRIC_NAMES[worst]}; tolerance {RESUME_STEP_TOL})")
        if not bool(torch.isfinite(metrics[1]).all()) or float(rel.max()) > RESUME_STEP_TOL:
            raise AssertionError(f"the rebuilt trainer's step disagrees with run A's: {metrics[1].tolist()} vs "
                                 f"{metrics[0].tolist()}")
        steps_a = run_a["gradient_steps"]
        del run_a, live, trainer, trainer_a, trainer_b, wm, actor, critic, target, batch  # run B's peak is its own
        gc.collect()  # run A's modules sit in reference cycles
        torch.cuda.empty_cache()

        # run B: resume from the middle checkpoint through the CLI, on the JAX loop's resume schedule
        run_b, launches_b = drive("resume B", overrides + [
            f"checkpoint.resume_from={middle}", "checkpoint.resume_preserve=[algo.total_steps]",
            f"algo.total_steps={RESUME_B_TOTAL_STEPS}"])
        if ckpt.load_state(middle)["counter"] != RESUME_MIDDLE_STEPS or run_b["gradient_steps"] != RESUME_B_STEPS \
                or run_b["live"]["trainer"].counter != RESUME_MIDDLE_STEPS + RESUME_B_STEPS:
            raise AssertionError(f"run B took {run_b['gradient_steps']} gradient steps (counter "
                                 f"{run_b['live']['trainer'].counter}); the resume schedule gives {RESUME_B_STEPS} "
                                 f"after the checkpoint's {RESUME_MIDDLE_STEPS}")
        size = os.path.getsize(last)
        log(f"[resume] save {save_s:.3f} s, file read {read_s:.3f} s, load into the trainer {load_s:.3f} s, "
            f"checkpoint {size} bytes (the timed save wrote {info['size']} bytes) [{card}]")
        print(json.dumps({"resume": "S", "card": card, "save_s": save_s, "read_s": read_s, "load_s": load_s,
                          "checkpoint_bytes": size, "train_step_max_abs_diff": float(diff.max()),
                          "train_step_max_rel_diff": float(rel.max()), "run_a_steps": steps_a,
                          "run_b_steps": run_b["gradient_steps"],
                          "run_b_seconds_per_step": run_b["seconds_per_step"]}), flush=True)
    finally:
        os.chdir(cwd)
    return {k: launches_a[k] + launches_b[k] for k in launches_a}, os.path.join(tmp, last)


def profile_train_step(dev, out_dir: str = "chiprun_out", overrides=()) -> None:
    """Where one gradient step's time goes: ``torch.profiler`` over a warm step
    on a random batch (the main path's shapes and config; ``overrides`` such as
    ``algo=dreamer_v3_XL`` pick another size than DV3-S, ``exp=dream_and_ponder``
    picks DAP-S), device time by kernel and the device's busy share of the
    step's wall clock."""
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.config import compose, instantiate
    from sheeprl_tpu_torch.envs import spaces

    cfg = compose(["exp=dreamer_v3", "env=dummy", "algo.world_model.kernels=auto", *overrides])
    if cfg.algo.name == "dream_and_ponder":
        from sheeprl_tpu_torch.algos.dream_and_ponder.agent import build_agent
        from sheeprl_tpu_torch.algos.dream_and_ponder.dream_and_ponder import DAPTrainer as Trainer

        which, name = "DAP", "dap_S"
    else:
        from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
        from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer as Trainer

        which = next((o.rsplit("_", 1)[-1] for o in overrides if o.startswith("algo=dreamer_v3_")), "S")
        name = f"dv3_{which}"
    torch.set_float32_matmul_precision(str(cfg.float32_matmul_precision))
    runtime = instantiate(cfg.fabric)
    obs_space = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 64, 64), dtype="uint8")})
    wm, actor, critic, target, _ = build_agent(runtime, [2], False, cfg, obs_space)
    trainer = Trainer(wm, actor, critic, target, cfg, runtime, False, [2])
    gen = torch.Generator(device=dev).manual_seed(0)
    T, B = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size)
    batch = {
        "rgb": torch.randint(0, 256, (T, B, 3, 64, 64), generator=gen, device=dev, dtype=torch.uint8),
        "actions": torch.nn.functional.one_hot(torch.randint(0, 2, (T, B), generator=gen, device=dev), 2).float(),
        "rewards": torch.zeros(T, B, 1, device=dev), "terminated": torch.zeros(T, B, 1, device=dev),
        "is_first": torch.zeros(T, B, 1, device=dev),
    }
    for _ in range(2):
        trainer.train_step(batch, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    table = events.table(sort_by="self_cuda_time_total", row_limit=25)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_train_step_{which}.txt"), "w") as f:
        f.write(table)
    log(table)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print(json.dumps({"profile": f"{name}_train_step", "card": smi(), "wall_ms": wall * 1e3,
                      "device_busy_ms": device_us / 1e3, "device_busy_share": device_us / 1e3 / (wall * 1e3),
                      "top_device_ms": {e.key: e.self_device_time_total / 1e3 for e in top}}), flush=True)


def smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv) -> int:
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full float32
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    log(f"[card] {card}")
    log(f"[torch] {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"[build] {path} in {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    ptxas = os.path.join(_build.BUILD_DIR, "ptxas.log")
    if os.path.isfile(ptxas):
        log(open(ptxas).read().strip())

    errors = {}
    for size in SIZES:
        for kind in ("dyn", "imag"):
            batches = (DYN_B if kind == "dyn" else IMAG_B,) + ((RAGGED_B[kind],) if size in RAGGED_SIZES else ())
            if kind == "imag" and size in RAGGED_SIZES:
                batches += (DAP_IMAG_B, DAP_RAGGED_B)
            for dtype in ("float32", "bfloat16"):
                for B in batches:
                    err = check_kernel(kind, dtype, dev, B, size)
                    if dtype == "bfloat16":
                        errors[kind] = max(errors.get(kind, 0.0), err)
    timings = time_kernels(dev)

    launches = {k: 0 for k in K.LAUNCHES}
    for size, total_steps in MAIN_PATHS:
        for k, n in main_path(size, total_steps).items():
            launches[k] += n
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        dap_launches, dap_ckpt = dap_path(work)
        resume_launches, dv3_ckpt = resume_phase(dev, card, work)
        for k in launches:
            launches[k] += dap_launches[k] + resume_launches[k]
        eval_phase((("dream_and_ponder", dap_ckpt), ("dreamer_v3", dv3_ckpt)), card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for arg in argv:
        if arg == "--profile" or arg.startswith("--profile="):
            which = arg.partition("=")[2] or "S"
            profile_train_step(dev, overrides=["exp=dream_and_ponder"] if which == "DAP" else [f"algo=dreamer_v3_{which}"])

    kernels = []
    for kind, replaces in (("dyn", "sheeprl_tpu/ops/pallas/rssm_step.py:392"), ("imag", "sheeprl_tpu/ops/pallas/rssm_step.py:406")):
        ms, plain_ms, bound, bound_by = timings[KERNELS_LINE_SIZE][kind]
        kernels.append({
            "name": f"rssm_{kind}_step", "route": "cuda", "source": "sheeprl_tpu_torch/ops/csrc/rssm_step.cu",
            "replaces": replaces, "launches": launches[f"rssm_{kind}_step"], "max_abs_err": errors[kind],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
