"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --profile       # also: torch.profiler over one DV3-S gradient step

Phases, each of which raises (exit code != 0) when it fails:

1. the card's name and power limit, as nvidia-smi reports them;
2. build the CUDA RSSM kernels from the sources in the checkout (nvcc, sm_90a);
3. for both kernels, at the DreamerV3-S shapes of the main path and at a ragged
   batch (B=17 dyn, B=1000 imag: the masked edges of the tiles), in float32 and
   bfloat16: the kernel against its plain PyTorch version on the same inputs,
   forward and gradients through the autograd.Function;
4. time each kernel (median of 30 launches, CUDA events) beside its plain
   version, its bound, max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s), and the
   step's products alone through torch.matmul (``products_library_ms``, a
   yardstick the port never calls); count the device kernels of one wrapper
   call with torch.profiler (``launches_per_call``);
5. the main path: ``python -m sheeprl_tpu_torch exp=dreamer_v3 env=dummy
   algo.world_model.kernels=auto`` at full S width and bf16-mixed, for a few
   gradient steps, with every launch counter set to 0 just before and read just
   after: finite losses, and exactly 64 dyn / 15 imag launches per step;
6. the ``kernels`` JSON line, then the device JSON line last.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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

# DreamerV3-S at 64x64 rgb on discrete_dummy (action_dim 2): the CNN encoder
# (multiplier 32, 4 stages) gives 8*32*4*4 = 4096 features
S_DIMS = dict(A=2, E=4096, DU=512, R=512, HT=512, HR=512, S=32, D=32)
DYN_B = 16  # per_rank_batch_size
IMAG_B = 16 * 64  # batch x sequence: every posterior starts an imagined trajectory
RAGGED_B = {"dyn": 17, "imag": 1000}  # batches that end inside a tile
TOL = {"float32": dict(rtol=1e-4, atol=1e-5, margin=1e-3), "bfloat16": dict(rtol=2e-2, atol=2e-2, margin=5e-2)}


def log(msg: str) -> None:
    print(msg, flush=True)


def spec_for(dtype: str) -> K.RSSMStepSpec:
    d = S_DIMS
    return K.RSSMStepSpec(
        action_size=d["A"], embed_size=d["E"], dense_units=d["DU"], recurrent_size=d["R"],
        trans_hidden=d["HT"], repr_hidden=d["HR"], stochastic=d["S"], discrete=d["D"], unimix=0.01,
        eps_in=1e-3, eps_gru=1e-3, eps_trans=1e-3, eps_repr=1e-3, dtype=dtype,
    )


def random_params(gen: torch.Generator, dev) -> dict:
    d = S_DIMS
    SD = d["S"] * d["D"]
    shapes = {
        "wi": (d["DU"], SD + d["A"]), "wg": (3 * d["R"], d["R"] + d["DU"]), "wt": (d["HT"], d["R"]),
        "wt_head": (SD, d["HT"]), "wr": (d["HR"], d["R"] + d["E"]), "wr_head": (SD, d["HR"]),
    }
    w = {k: torch.randn(s, generator=gen, device=dev) / (s[1] ** 0.5) for k, s in shapes.items()}
    ln = lambda n: (1.0 + 0.05 * torch.randn(n, generator=gen, device=dev), 0.05 * torch.randn(n, generator=gen, device=dev))  # noqa: E731
    p = {"wi_z": w["wi"][:, :SD], "wi_a": w["wi"][:, SD:], "wg_h": w["wg"][:, : d["R"]], "wg_f": w["wg"][:, d["R"]:],
         "wt": w["wt"], "wt_head": w["wt_head"], "wr_h": w["wr"][:, : d["R"]], "wr_e": w["wr"][:, d["R"]:],
         "wr_head": w["wr_head"],
         "bt_head": 0.01 * torch.randn(SD, generator=gen, device=dev),
         "br_head": 0.01 * torch.randn(SD, generator=gen, device=dev)}
    for key, n in (("i", d["DU"]), ("g", 3 * d["R"]), ("t", d["HT"]), ("r", d["HR"])):
        p[f"ln_{key}_scale"], p[f"ln_{key}_bias"] = ln(n)
    return p


def gumbel(shape, gen, dev):
    u = torch.rand(shape, generator=gen, device=dev).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def dyn_inputs(gen, dev, B):
    d = S_DIMS
    SD = d["S"] * d["D"]
    is_first = (torch.rand(B, 1, generator=gen, device=dev) < 0.25).float()
    return dict(
        init_h=torch.tanh(torch.randn(1, d["R"], generator=gen, device=dev)).expand(B, -1),
        init_z=torch.nn.functional.one_hot(torch.randint(0, d["D"], (B, d["S"]), generator=gen, device=dev), d["D"]).float().reshape(B, SD),
        h=torch.tanh(torch.randn(B, d["R"], generator=gen, device=dev)),
        z=torch.nn.functional.one_hot(torch.randint(0, d["D"], (B, d["S"]), generator=gen, device=dev), d["D"]).float().reshape(B, SD),
        a=torch.nn.functional.one_hot(torch.randint(0, d["A"], (B,), generator=gen, device=dev), d["A"]).float(),
        e=torch.randn(B, d["E"], generator=gen, device=dev),
        f=is_first,
        g=gumbel((B, d["S"], d["D"]), gen, dev),
    )


def imag_inputs(gen, dev, B):
    full = dyn_inputs(gen, dev, B)
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


def check_kernel(kind: str, dtype: str, dev, B: int) -> float:
    """Kernel vs plain version at batch ``B``; returns the worst forward abs error."""
    tol = TOL[dtype]
    gen = torch.Generator(device=dev).manual_seed(7)
    spec = spec_for(dtype)
    p32 = random_params(gen, dev)
    pc = K.compute_params(p32, spec)
    x = dyn_inputs(gen, dev, B) if kind == "dyn" else imag_inputs(gen, dev, B)
    c = spec.compute_dtype
    x = {k: (v.to(c) if k not in ("f", "g") else v) for k, v in x.items()}
    log(f"[kernel] rssm_{kind}_step {dtype} B={B}")
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
    once, and the products' operations at the dense bf16 peak."""
    d, SD = S_DIMS, spec.stoch_flat
    cb = torch.tensor([], dtype=spec.compute_dtype).element_size()
    products = [(SD + d["A"], d["DU"]), (d["R"] + d["DU"], 3 * d["R"]), (d["R"], d["HT"]), (d["HT"], SD)]
    ln_params = 2 * (d["DU"] + 3 * d["R"] + d["HT"])
    head_bias = SD
    if kind == "dyn":
        products += [(d["R"] + d["E"], d["HR"]), (d["HR"], SD)]
        ln_params += 2 * d["HR"]
        head_bias += SD
        act_in = B * (d["R"] * 2 + SD * 2 + d["A"] + d["E"]) * cb + B * 4 + B * SD * 4  # init_h init_z h z a e, f, gumbel
        act_out = B * (d["R"] + SD) * cb + 2 * B * SD * 4
    else:
        act_in = B * (d["R"] + SD + d["A"]) * cb + B * SD * 4
        act_out = B * (d["R"] + SD) * cb
    weights = sum(k * n for k, n in products)
    nbytes = weights * cb + head_bias * cb + ln_params * 4 + act_in + act_out
    flops = 2 * B * weights
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def device_kernels(fn):
    """Names of the device kernels one call of ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def step_products(kind: str, spec: K.RSSMStepSpec, pc, B: int, gen, dev):
    """The step's products alone, at the kernel's shapes and dtype, through
    torch.matmul (a yardstick for the product part; the port never calls it)."""
    d, SD = S_DIMS, spec.stoch_flat
    pairs = [("wi_z", SD), ("wi_a", d["A"]), ("wg_h", d["R"]), ("wg_f", d["DU"]), ("wt", d["R"]), ("wt_head", d["HT"])]
    if kind == "dyn":
        pairs += [("wr_h", d["R"]), ("wr_e", d["E"]), ("wr_head", d["HR"])]
    acts = [torch.randn(B, k, generator=gen, device=dev).to(spec.compute_dtype) for _, k in pairs]
    weights = [pc[key].t() for key, _ in pairs]
    return lambda: [torch.matmul(x, w) for x, w in zip(acts, weights)]


def time_kernel(kind: str, dev):
    spec = spec_for("bfloat16")  # the main path runs bf16-mixed
    gen = torch.Generator(device=dev).manual_seed(11)
    p32 = random_params(gen, dev)
    pc = K.compute_params(p32, spec)
    B = DYN_B if kind == "dyn" else IMAG_B
    x = dyn_inputs(gen, dev, B) if kind == "dyn" else imag_inputs(gen, dev, B)
    x = {k: (v.to(torch.bfloat16).contiguous() if k not in ("f", "g") else v) for k, v in x.items()}
    name = f"rssm_{kind}_step"
    wrapper = K.rssm_dyn_step if kind == "dyn" else K.rssm_imag_step
    plain = K.dyn_math if kind == "dyn" else K.imag_math
    products = step_products(kind, spec, pc, B, gen, dev)
    saved = dict(K.LAUNCHES)
    with torch.no_grad():
        t_plain_a = device_ms(lambda: plain(pc, spec, *x.values()))
        t_kernel_a = device_ms(lambda: wrapper(spec, pc, *x.values()))
        t_lib_a = device_ms(products)
        t_lib_b = device_ms(products)
        t_kernel_b = device_ms(lambda: wrapper(spec, pc, *x.values()))
        t_plain_b = device_ms(lambda: plain(pc, spec, *x.values()))
        names = device_kernels(lambda: wrapper(spec, pc, *x.values()))
    K.LAUNCHES.update(saved)  # timing launches are not main-path launches
    log(f"[time] {name} device kernels of one call: {names}")
    if len(names) != K.DEVICE_LAUNCHES_PER_CALL[name]:
        raise AssertionError(f"{name}: {len(names)} device kernels per call, expected {K.DEVICE_LAUNCHES_PER_CALL[name]}")
    bound, bound_by, nbytes, flops = step_bound_ms(kind, spec, B)
    ms, plain_ms = min(t_kernel_a, t_kernel_b), min(t_plain_a, t_plain_b)
    log(f"[time] {name} bf16 B={B}: kernel {t_kernel_a:.4f}/{t_kernel_b:.4f} ms, "
        f"plain {t_plain_a:.4f}/{t_plain_b:.4f} ms, products through torch.matmul {t_lib_a:.4f}/{t_lib_b:.4f} ms, "
        f"bound {bound:.4f} ms ({bound_by}; {nbytes} B, {flops} FLOP)")
    print(json.dumps({"timing": name, "batch": B, "dtype": "bfloat16", "kernel_ms": [t_kernel_a, t_kernel_b],
                      "plain_ms": [t_plain_a, t_plain_b], "products_library_ms": [t_lib_a, t_lib_b],
                      "launches_per_call": len(names), "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
                      "flops": flops}), flush=True)
    return ms, plain_ms, bound, bound_by


def main_path(dev):
    """The port's CLI entry at DV3-S width, kernels=auto, bf16-mixed."""
    from sheeprl_tpu_torch import cli

    overrides = [
        "exp=dreamer_v3", "env=dummy", "algo.world_model.kernels=auto",
        # depth cuts only: a short run, a small replay, no video
        "env.num_envs=4", "env.sync_env=True", "env.capture_video=False",
        "algo.learning_starts=260", "algo.total_steps=268", "buffer.size=4096", "buffer.memmap=False",
        "metric.log_every=4", "algo.run_test=False",
    ]
    log(f"[main] python -m sheeprl_tpu_torch {' '.join(overrides)}")
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    summary = cli.run(overrides)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    steps = summary["gradient_steps"]
    log(f"[main] gradient steps {steps}, launches {launches}")
    log(f"[main] losses per train call: {json.dumps(summary['losses'])}")
    log(f"[main] seconds per gradient step (after the first train call): {summary['seconds_per_step']}")
    log(f"[main] peak torch.cuda.max_memory_allocated: {torch.cuda.max_memory_allocated()} bytes")
    if steps < 4:
        raise AssertionError(f"the main path took {steps} gradient steps, expected at least 4")
    for row in summary["losses"]:
        for name, value in row.items():
            if not (value == value and abs(value) != float("inf")):
                raise AssertionError(f"non-finite {name} in the main path: {value}")
    if launches["rssm_dyn_step"] != 64 * steps or launches["rssm_imag_step"] != 15 * steps:
        raise AssertionError(f"launch counts {launches} != 64 and 15 per gradient step x {steps} steps")
    return launches


def profile_train_step(dev, out_dir: str = "chiprun_out", overrides=()) -> None:
    """Where one DV3-S gradient step's time goes: ``torch.profiler`` over a
    warm step on a random batch (the main path's shapes and config), device
    time by kernel and the device's busy share of the step's wall clock."""
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer
    from sheeprl_tpu_torch.config import compose, instantiate
    from sheeprl_tpu_torch.envs import spaces

    cfg = compose(["exp=dreamer_v3", "env=dummy", "algo.world_model.kernels=auto", *overrides])
    torch.set_float32_matmul_precision(str(cfg.float32_matmul_precision))
    runtime = instantiate(cfg.fabric)
    obs_space = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 64, 64), dtype="uint8")})
    wm, actor, critic, target, _ = build_agent(runtime, [2], False, cfg, obs_space)
    trainer = DV3Trainer(wm, actor, critic, target, cfg, runtime, False, [2])
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
    with open(os.path.join(out_dir, "profile_train_step.txt"), "w") as f:
        f.write(table)
    log(table)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print(json.dumps({"profile": "dv3_s_train_step", "wall_ms": wall * 1e3, "device_busy_ms": device_us / 1e3,
                      "device_busy_share": device_us / 1e3 / (wall * 1e3),
                      "top_device_ms": {e.key: e.self_device_time_total / 1e3 for e in top}}), flush=True)


def main(argv) -> int:
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full float32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[torch] {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"[build] {path} in {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    ptxas = os.path.join(_build.BUILD_DIR, "ptxas.log")
    if os.path.isfile(ptxas):
        log(open(ptxas).read().strip())

    errors = {}
    for kind in ("dyn", "imag"):
        for dtype in ("float32", "bfloat16"):
            for B in (DYN_B if kind == "dyn" else IMAG_B, RAGGED_B[kind]):
                err = check_kernel(kind, dtype, dev, B)
                if dtype == "bfloat16":
                    errors[kind] = max(errors.get(kind, 0.0), err)
    timings = {kind: time_kernel(kind, dev) for kind in ("dyn", "imag")}

    launches = main_path(dev)
    if "--profile" in argv:
        profile_train_step(dev)

    kernels = []
    for kind, replaces in (("dyn", "sheeprl_tpu/ops/pallas/rssm_step.py:392"), ("imag", "sheeprl_tpu/ops/pallas/rssm_step.py:406")):
        ms, plain_ms, bound, bound_by = timings[kind]
        kernels.append({
            "name": f"rssm_{kind}_step", "route": "cuda", "source": "sheeprl_tpu_torch/ops/csrc/rssm_step.cu",
            "replaces": replaces, "launches": launches[f"rssm_{kind}_step"], "max_abs_err": errors[kind],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
