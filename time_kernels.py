#!/usr/bin/env python3
"""Time the 2D Lanczos kernels K2, K2' and K3 and the 2D steps on one GPU.

    python3 time_kernels.py [--root TREE] [--tag NAME] [--out FILE]

Imports nlsolvers_tpu_torch from TREE (default: the directory of this
script), so that one machine can time two versions of the package in turns
(run it for each tree, in the order old, new, new, old); the timing helpers
are this script's chip_smoke.py's, whatever TREE is. Imports torch, numpy,
chip_smoke and that package only.

Kernel readings, per step of the kernel's path (K2 / K2': the m-1 launches
j = 0..m-2 of one Lanczos run, the last one LAST; K3: one combine with
k = 1), each on the same inputs:
  graph     the step's launches captured once in a torch.cuda.CUDAGraph
            (warmed up on a side stream), replayed back to back with CUDA
            events around the replays: device time without the host's
            enqueue;
  profiler  the summed device time of the kernel rows of torch.profiler
            over the repeated steps;
  events    CUDA events around each eager step, median: device time, or
            the host's enqueue time where that is longer.
Beside them the bytes bound (each input read once, each output written
once, at 3.35 TB/s) and, for K3, torch.matmul of the same coefficients over
the same columns (complex64). Sizes: 1024^2 and 4096^2, m = 10 and 20.

Step rates by chip_smoke.py's `rate` (steps/s, the median of 3
synchronized chunks after a warm-up; device busy time, idle share and the
top kernels from torch.profiler over 5 steps): 1024^2 iso SS2, 1024^2 c(x)
SS2 and c(x) sEWI, 4096^2 iso SS2 (the cubic NLSE of chip_smoke.py).

Prints one JSON object per kernel reading and writes them all to --out.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

LX, DT = 10.0, 1e-4


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs         # this script's timing helpers, not TREE's
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from nlsolvers_tpu_torch.models import problems
    from nlsolvers_tpu_torch.ops import operators
    from nlsolvers_tpu_torch.ops.cuda import _build
    from nlsolvers_tpu_torch.ops.cuda import lanczos2d as lz
    check_root = Path(lz.__file__).resolve().parents[3]
    assert check_root == Path(args.root).resolve(), check_root
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    _build.build_all(["lanczos2d"])
    print(f"[{args.tag}] {smi}; root {args.root}; build "
          f"{time.perf_counter() - t0:.1f} s")
    results = []

    def emit(**kw):
        kw = dict(tag=args.tag, card=smi, **kw)
        results.append(kw)
        print(json.dumps(kw))

    gen = torch.Generator(device=dev).manual_seed(7)

    def field(n, P=2):
        return torch.randn((P, n, n), generator=gen, device=dev)

    def readings(name, n, m, fn, nbytes, launches, reps, extra=None):
        g = cs.graph_ms(torch, fn, reps)
        p, e = cs.times_ms(torch, fn, reps)
        bound = cs.bound_ms(nbytes)
        emit(kernel=name, n=n, m=m, graph_ms=g, graph_ms_per_launch=(
            g / launches), profiler_ms=p, events_ms=e, bound_ms=bound,
             mbytes=nbytes / 1e6, share_graph=bound / g,
             share_profiler=bound / p, **(extra or {}))

    for n in (1024, 4096):
        dx = 2.0 * LX / (n - 1)
        desc = operators.laplacian_2d((n, n), dx, dx, device=dev).kernel_desc
        c = torch.from_numpy((1.0 + 0.4 * np.random.default_rng(0).random(
            (n, n))).astype(np.float32))
        desc_a = operators.anisotropic_laplacian_2d(
            c, dx, dx, device=dev).kernel_desc
        col = 2 * n * n * 4
        reps = 20 if n == 1024 else 5
        for m in (10, 20):
            W = [field(n) for _ in range(m)]
            av = field(n)
            scs = []
            for j in range(m - 1):
                s = torch.rand((j + 2, 2), generator=gen, device=dev) - 0.5
                s[0, 0], s[0, 1] = 0.8, 0.0
                scs.append(s)
            k2_cols = sum(j + 4 for j in range(m - 2)) + m + 1
            for name, fn_k, d, wbytes in (
                    ("K2", lz.pipe_iso2d, desc, 0),
                    ("K2'", lz.pipe_aniso2d, desc_a, 2 * n * n * 4)):
                def step(fn_k=fn_k, d=d):
                    for j in range(m - 1):
                        fn_k(scs[j], av, W[:j + 1], d, j == m - 2)
                readings(name, n, m, step,
                         k2_cols * col + (m - 2) * wbytes, m - 1, reps)
            q = torch.rand((1, m, 2), generator=gen, device=dev) - 0.5
            Wc = torch.stack([torch.complex(w[0], w[1]).reshape(-1)
                              for w in W])
            qc = torch.complex(q[..., 0], q[..., 1])
            mm = {"matmul_graph_ms": cs.graph_ms(
                torch, lambda: torch.matmul(qc, Wc), reps),
                  "matmul_profiler_ms": cs.times_ms(
                      torch, lambda: torch.matmul(qc, Wc), reps)[0]}
            readings("K3", n, m, lambda: lz.combine(q, W), (m + 1) * col, 1,
                     reps, mm)
            del W, av, Wc
            torch.cuda.empty_cache()

    # step rates
    def gaussian(n):
        x = torch.linspace(-LX, LX, n, dtype=torch.float32)
        X, Y = torch.meshgrid(x, x, indexing="ij")
        env = torch.exp(-(X ** 2 + Y ** 2) / 4)
        return torch.stack([env * torch.cos(0.5 * X), env * torch.sin(0.5 * X)])

    def problem(n, integrator="ss2", aniso=False):
        c = None
        if aniso:
            c = torch.from_numpy((1.0 + 0.4 * np.random.default_rng(0).random(
                (n, n))).astype(np.float32))
        prob = problems.nlse_problem("cubic", (n, n), LX, DT,
                                     m_field=torch.ones((n, n)), c_field=c,
                                     krylov_m=10, integrator=integrator,
                                     dtype=torch.complex64)
        assert prob.meta["planar_state"] and prob.meta["device"] == "cuda"
        return prob, prob.init(gaussian(n))

    for label, n, integ, aniso, chunk in (
            ("1024^2 iso SS2", 1024, "ss2", False, 200),
            ("1024^2 c(x) SS2", 1024, "ss2", True, 200),
            ("1024^2 c(x) sEWI", 1024, "sewi", True, 50),
            ("4096^2 iso SS2", 4096, "ss2", False, 20)):
        label = f"[{args.tag}] rate {label}"
        cs.rate(torch, {label: problem(n, integ, aniso)}, chunk, [label] * 3,
                5)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
