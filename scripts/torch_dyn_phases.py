"""Where the time of the port's dynamic RSSM step goes, phase by phase (CUDA).

``rssm_dyn_step`` is one cooperative launch whose nine phases are separated by
grid-wide barriers. This script builds a copy of
``sheeprl_tpu_torch/ops/csrc/rssm_step.cu`` in which every block returns after
phase ``stop`` (a field added to the end of ``Dims``), and prints the device
time of one call cut after each phase, at the main path's shape (DV3-S, B=16,
bfloat16, random weights from a seed). The difference between two lines is
the time of one phase; "stop after phase 0" is the launch and the grid alone.
The kernel in the repository is not changed.

    python3 scripts/torch_dyn_phases.py    # on a machine with an H100 and nvcc
"""

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402  (exits unless a CUDA card is present)
from sheeprl_tpu_torch.ops import _build  # noqa: E402

K = C.K


def cut_source(src: str) -> tuple:
    """The kernel source with a ``stop`` field and a return after phase
    ``stop``; returns (source, number of barriers)."""
    src, n = re.subn(r"(struct Dims \{.*?)\n\};", r"\1\n  int stop;  // return after this phase\n};", src, count=1,
                     flags=re.S)
    assert n == 1, "struct Dims not found"
    head = "  cg::grid_group grid = cg::this_grid();\n"
    assert src.count(head) == 1, "the cooperative kernel's grid handle not found"
    src = src.replace(head, head + "  if (g.d.stop == 0) return;\n")
    barriers = [0]

    def cut(_m):
        barriers[0] += 1
        return f"  grid.sync();\n  if (g.d.stop == {barriers[0]}) return;\n"

    src = re.sub(r"  grid\.sync\(\);\n", cut, src)
    assert barriers[0] > 0, "no grid barrier found"
    return src, barriers[0]


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    with open(_build.SOURCE) as f:
        src, n_barriers = cut_source(f.read())
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    _build.SOURCE = os.path.join(_build.BUILD_DIR, "rssm_step_phases.cu")
    with open(_build.SOURCE, "w") as f:
        f.write(src)
    _build.load()

    stop = [n_barriers + 1]
    plain_dims = K._dims

    def dims(*args, **kwargs):
        vals = list(plain_dims(*args, **kwargs))
        return (ctypes.c_int * (len(vals) + 1))(*vals, stop[0])

    K._dims = dims
    dev = torch.device("cuda", 0)
    spec = C.spec_for("bfloat16")
    gen = torch.Generator(device=dev).manual_seed(11)
    pc = K.compute_params(C.random_params(gen, dev), spec)
    x = {k: v if k in ("f", "g") else v.to(torch.bfloat16).contiguous()
         for k, v in C.dyn_inputs(gen, dev, C.DYN_B).items()}
    with torch.no_grad():
        for s in range(n_barriers + 2):
            stop[0] = s
            ms = C.device_ms(lambda: K.rssm_dyn_step(spec, pc, *x.values()))
            label = "all" if s > n_barriers else s
            print(f"[phases] rssm_dyn_step bf16 B={C.DYN_B}: stop after phase {label}: {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
