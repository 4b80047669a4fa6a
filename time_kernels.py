#!/usr/bin/env python3
"""Time the pipelined Lanczos kernels and the steps that run them on one GPU.

    python3 time_kernels.py [--root TREE] [--tag NAME] [--out FILE]
                            [--parts 2d,k8,k13,k5,k1,rates,optin]
                            [--ms 10,20]

(other parts: kickbc, rates3d, shard, perj, ptxas, datagen, sweeps, run3d,
shard-datagen, shard3d-bricks)

Imports nlsolvers_tpu_torch from TREE (default: the directory of this
script), so that one machine can time two versions of the package in turns
(run it for each tree, in the order old, new, new, old); the timing helpers
are this script's chip_smoke.py's, whatever TREE is. Imports torch, numpy,
chip_smoke and that package only.

Kernel readings, per step of the kernel's path, each on the same inputs:
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
the same columns (complex64). Parts:
  2d     K2 / K2' (the m-1 launches j = 0..m-2 of one Lanczos run, the last
         one LAST) and K3 (one combine, k = 1) at 1024^2 and 4096^2, m = 10
         and 20;
  k8     K8 (pipe_3d, the m-2 launches j = 0..m-3 of one 3D Lanczos run)
         at 128^3 and 256^3, iso and c(x), m = 10 and 20, and the bricks
         the wrapper picked (trees that pick them in Python);
  k13    K13 (ss2_resident_step, one whole SS2 step) at 1024^2 and 4096^2,
         m = 10 and 20, beside its operations bound and the streaming
         floors of both designs (the two-pass loop's and the pipelined
         one's);
  k5     K5 (iter_step, the m-1 launches j = 0..m-2 of one fused-iteration
         Lanczos run) at 1024^2 and 128^3 iso (w on chip) and 2048^2 (w in
         a device scratch), m = 10 and 20, with the form of w the wrapper
         picked (trees that pick it);
  k1     K1 and K1' (pass1_iso2d, pass1_aniso2d) at 1024^2 and 4096^2, at
         j = 0 (the main path's one launch per matrix function) and
         j = m - 2;
  perj   K5 at each j = 0..8 and K1 at j in {0, 1, 2, 4, 8}, one launch each
         by graph, at 1024^2 and 2048^2 (where a run's time goes);
  kickbc the step's closing epilogue per step: both half kicks and the
         no-flux ghost copy, as the tree's SS2 step runs them (two kick_bc
         launches, the closing one with the copy, where the tree has
         ops/cuda/kick.py; else the eager kicks and the plain 2D copy or
         the bc3d kernel), and on a tree with kick_bc also the eager ops it
         replaces and kick_bc alone with and without the copy; at 1024^2,
         4096^2, 128^3 and 256^3, and summed over the shards of 4096^2 on
         (2, 2) and 512^3 on (2, 2, 2) (a sharded tree's 2D copy is its
         where-masks, its 3D copy bc3d with offsets); beside 20 bytes per
         cell per kick;
  datagen the datagen production point (benchmarks/datagen_bench.py:
         22-26: cubic NLSE 256^2, m = 20, c layered, m piecewise, T = 1.2,
         nt = 2000, 128 snapshots, batch 8; a tree with
         nlsolvers_tpu_torch/pipeline only): the kernels of one
         trajectory-step (K1' at j = 0, the 19 K2' launches, K3 beside
         torch.matmul, the two kick_bc), on a tree with the batched
         kernels their batched forms over the 8 lanes by chip_smoke.py's
         parity-batched (checked, then timed per batched step beside the
         8 unbatched launch sequences), the engine as that benchmark
         drives JAX's (guard off, dispatch to readback, the better of two
         calls), one batched step's device profile (busy ms, idle share,
         launches per batched step and per trajectory-step, host syncs),
         and the sweep through Datagen.run (sampling, guard, npy archive);
  sweeps the datagen sweeps beside the NLSE production one, as
         chip_smoke.py's rate-datagen runs them (chip_smoke.DG_SWEEPS:
         2D NLSE sEWI at 256^2, m = 20; 2D sine-Gordon Gautschi at 256^2,
         3D NLSE SS2 and 3D Klein-Gordon Gautschi at 128^3, m = 10; 8 runs
         in one batch, c layered, m piecewise): one batched step's wall,
         device busy time, idle share and launches, and the sweep through Datagen.run,
         trajectories/min (on any tree with nlsolvers_tpu_torch/pipeline:
         a tree that steps those lanes one at a time is timed as it runs);
  run3d  one unbatched 3D two-pass Lanczos run (lanczos_planar at 128^3,
         iso, m = 10, complex): the host's enqueue time (median of 40
         runs, no sync inside the run) and the wall with the sync, the
         device time by CUDA-graph replay and the profiler's kernel rows
         per run, to compare two trees' unbatched 3D loop;
  shard-datagen  the grid-sharded datagen path (a tree with the sharded
         engines): the shard kernels by CUDA-graph replay, unbatched per
         step of the sharded main paths (every shard's m-1 launches, m =
         10: 4096^2 on (2, 2) reference and c(x), 512^3 on (2, 2, 2) clean
         and c(x)) beside their bytes bound, and batched over B = 2 lanes
         per batched sharded Lanczos run at the datagen-shard points by
         chip_smoke.py's parity-batched-shard (checked, then timed beside
         the lanes' unbatched launch sequences); then the batched sharded
         SS2 step (c(x), 1024^2 m = 20 on (2, 2) and 256^3 m = 10 on
         (1, 1, 4), B = 2, and 1024^2 at B = 8) beside the same lanes
         stepped one at a time through make_sharded_nlse_step, chunks
         interleaved, by chip_smoke.py's `rate` (ms per batched step,
         device busy time, idle share, launches, host syncs);
  shard3d-bricks  pass1_shard3d (a tree with lanczos3d.shard3d_tiles) by
         CUDA-graph replay with the bricks that helper picks and with
         others (put in its place for the run) (plane depths 4-64, tiles half as wide and twice
         as tall, or half as tall):
         one batched sharded Lanczos run (B = 2, m = 10) of the 3D
         datagen-shard point, (256, 256, 64) on (1, 1, 4), c(x) and iso,
         and the unbatched 512^3 on (2, 2, 2) c(x) one, beside the bytes
         bound;
  ptxas  ptxas's registers and spill stores of every kernel instantiation
         the tree builds, one JSON object each (the namespace hash of a
         name dropped), to compare two trees' code generation;
  rates  steps/s by chip_smoke.py's `rate` (the median of 3 synchronized
         chunks after a warm-up; device busy time, idle share and the top
         kernels from torch.profiler): 1024^2 iso SS2, 1024^2 c(x) SS2 and
         c(x) sEWI, 4096^2 iso SS2 (the cubic NLSE of chip_smoke.py);
  rates3d the same for 128^3 and 256^3 iso SS2;
  shard  the same for the sharded SS2 step (make_sharded_nlse_step, every
         shard on this card): 4096^2 on (2, 2), reference variant, and
         512^3 on (2, 2, 2), clean variant;
  optin  the same for the opt-in paths beside their defaults, chunks
         interleaved: resident vs default at 1024^2 and 4096^2 (and
         fused_iter at 1024^2), pipeline_3d vs two-pass at 128^3 and
         256^3 (and fused_iter at 128^3).

Prints one JSON object per kernel reading and writes them all to --out.
"""

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

LX, DT = 10.0, 1e-4


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--parts", default="2d,k8,k13,k5,k1,rates,optin")
    ap.add_argument("--ms", default="10,20")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    ms = [int(m) for m in args.ms.split(",")]
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
    from nlsolvers_tpu_torch.ops.cuda import lanczos3d as l3
    from nlsolvers_tpu_torch.ops.cuda import resident2d as rs
    from nlsolvers_tpu_torch.utils import interop
    check_root = Path(lz.__file__).resolve().parents[3]
    assert check_root == Path(args.root).resolve(), check_root
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    has_kick = (Path(args.root) / "nlsolvers_tpu_torch" / "ops" / "cuda"
                / "kick.py").exists()
    libs = ["lanczos2d", "lanczos3d", "resident2d"] + ["kick"] * has_kick
    _build.build_all(libs)
    print(f"[{args.tag}] {smi}; root {args.root}; build "
          f"{time.perf_counter() - t0:.1f} s")
    results = []

    def emit(**kw):
        kw = dict(tag=args.tag, card=smi, **kw)
        results.append(kw)
        print(json.dumps(kw))

    for lib in (libs if "ptxas" in parts else ()):
        lines = _build.build_log(lib).read_text().splitlines()
        for kname, nreg, spill in cs.kernel_resources(lines):
            emit(lib=lib, ptxas=re.sub(r"^_ZN\d+_GLOBAL__N__.*?_cu_[0-9a-f]{8}"
                                        r"\d+", "", kname), registers=nreg,
                 spill_bytes=spill)

    gen = torch.Generator(device=dev).manual_seed(7)

    def field(n, P=2, rows=None):
        """A random planar (P, rows, n) field; rows = n by default."""
        return torch.randn((P, n if rows is None else rows, n), generator=gen,
                           device=dev)

    def readings(name, n, m, fn, nbytes, launches, reps, extra=None,
                 bound=None):
        g = cs.graph_ms(torch, fn, reps)
        p, e = cs.times_ms(torch, fn, reps)
        bound = cs.bound_ms(nbytes) if bound is None else bound
        emit(kernel=name, n=n, m=m, graph_ms=g, graph_ms_per_launch=(
            g / launches), profiler_ms=p, events_ms=e, bound_ms=bound,
             mbytes=nbytes / 1e6, share_graph=bound / g,
             share_profiler=bound / p, **(extra or {}))

    for n in ((1024, 4096) if "2d" in parts else ()):
        dx = 2.0 * LX / (n - 1)
        desc = operators.laplacian_2d((n, n), dx, dx, device=dev).kernel_desc
        c = torch.from_numpy((1.0 + 0.4 * np.random.default_rng(0).random(
            (n, n))).astype(np.float32))
        desc_a = operators.anisotropic_laplacian_2d(
            c, dx, dx, device=dev).kernel_desc
        col = 2 * n * n * 4
        reps = 20 if n == 1024 else 5
        for m in ms:
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

    def dt_theta(n):
        """The time step of an n^2 grid at the theta (|dt| 8 scale = 2.09)
        of the 1024^2 point, so that the resident step takes it."""
        return DT * ((1024 - 1) / (n - 1)) ** 2

    # K8 at 128^3 and 256^3: the m-2 launches of one 3D Lanczos run
    for n in ((128, 256) if "k8" in parts else ()):
        d3 = 2.0 * LX / (n - 1)
        shape = (n, n, n)
        c3 = torch.from_numpy((1.0 + 0.4 * np.random.default_rng(0).random(
            shape)).astype(np.float32))
        descs = {"iso": operators.laplacian_3d(shape, d3,
                                               device=dev).kernel_desc,
                 "c(x)": operators.anisotropic_laplacian_3d(
                     c3, d3, device=dev).kernel_desc}
        col = 2 * n ** 3 * 4
        reps = 10 if n == 128 else 3
        for m in ms:
            W = [field(n, rows=n * n) for _ in range(m - 2)]
            av = field(n, rows=n * n)
            scs = []
            for j in range(m - 2):
                s = torch.rand((j + 2, 2), generator=gen, device=dev) - 0.5
                s[0, 0], s[0, 1] = 0.8, 0.0
                scs.append(s)
            cols = sum(j + 4 for j in range(m - 2))
            for op, d in descs.items():
                wbytes = 3 * n ** 3 * 4 if op == "c(x)" else 0

                def step(d=d):
                    for j in range(m - 2):
                        l3.pipe_3d(scs[j], av, W[:j + 1], d)

                nbytes = cols * col + (m - 2) * wbytes
                readings(f"K8 {op}", n, m, step, nbytes, m - 2, reps)
                if hasattr(l3, "_brick_cache"):
                    mode = 2 if op == "c(x)" else 0
                    emit(kernel=f"K8 {op} bricks", n=n, m=m, picked={
                        f"bucket {k[2]}": v for k, v in l3._brick_cache.items()
                        if k[4:7] == shape and k[1] == mode})
            del W, av
            torch.cuda.empty_cache()

    # K13 at 1024^2 and 4096^2: one whole SS2 step
    for n in ((1024, 4096) if "k13" in parts else ()):
        dx = 2.0 * LX / (n - 1)
        desc = operators.laplacian_2d((n, n), dx, dx, device=dev).kernel_desc
        dt = dt_theta(n)
        u = field(n) * 0.1
        mf = torch.ones((n, n), device=dev)
        col, pl = 2 * n * n * 4, n * n * 4
        reps = 20 if n == 1024 else 5
        for m in ms:
            sc = {}
            ops = n * n * (22 * (m - 1) + 8 * m * (m - 1) + 30 + 8 * m)
            floor_twopass = (col * (2 + sum(5 + 2 * j + (j > 0)
                                            for j in range(m - 1)) + m + 1)
                             + 2 * pl)
            floor_pipe = (col * (3 + sum(j + 4 for j in range(m - 2))
                                 + 2 * (m + 1)) + 2 * pl)
            readings("K13", n, m,
                     lambda: rs.ss2_resident_step(u, mf, desc, dt, m,
                                                  scratch=sc),
                     floor_pipe, 1, reps, bound=cs.ops_ms(ops),
                     extra=dict(floor_pipe_ms=cs.bound_ms(floor_pipe),
                                floor_twopass_ms=cs.bound_ms(floor_twopass)))
            del sc
            torch.cuda.empty_cache()

    def k5_scal(W, j):
        """K5's scalars [s_j, bs, s_0..s_j], inverse norms near 1/||W_i||
        (the loop's magnitudes)."""
        sv = ((0.5 + 0.5 * torch.rand(j + 1, generator=gen, device=dev))
              / torch.stack([w.norm() for w in W[:j + 1]]))
        return torch.cat([torch.stack([sv[j], sv[0] * 0 + 0.3]),
                          sv])[None].contiguous()

    # K5: the m-1 launches of one fused-iteration Lanczos run
    for n, three_d in (((1024, False), (2048, False), (128, True))
                       if "k5" in parts else ()):
        rows = n * n if three_d else n
        if three_d:
            d = operators.laplacian_3d((n, n, n), 2.0 * LX / (n - 1),
                                       device=dev).kernel_desc
        else:
            dx = 2.0 * LX / (n - 1)
            d = operators.laplacian_2d((n, n), dx, dx,
                                       device=dev).kernel_desc
        col = 2 * rows * n * 4
        for m in ms:
            W = [field(n, rows=rows) for _ in range(m - 1)]
            scs = [k5_scal(W, j) for j in range(m - 1)]

            def run(W=W, scs=scs, d=d, m=m):
                for j in range(m - 1):
                    lz.iter_step(scs[j], W[j], W[:j], d)

            form = {}
            if hasattr(lz, "iter_form"):
                onchip, grid = lz.iter_form(2, rows, n, lz._iter_opk(d, ""),
                                            m - 2, n % 4 == 0)
                form = dict(w_form="on-chip" if onchip else "global",
                            grid=grid)
            nbytes = sum(j + 2 for j in range(m - 1)) * col
            readings("K5", f"{n}^3" if three_d else n, m, run, nbytes, m - 1,
                     5 if n == 2048 else 10, form)
            del W, scs
            torch.cuda.empty_cache()

    # K5 and K1 launch by launch
    for n in ((1024, 2048) if "perj" in parts else ()):
        dx = 2.0 * LX / (n - 1)
        d = operators.laplacian_2d((n, n), dx, dx, device=dev).kernel_desc
        W = [field(n) for _ in range(10)]
        col = 2 * n * n * 4
        s1 = torch.tensor([[0.8, 0.3]], device=dev)
        for name, js in (("K5", range(9)), ("K1", (0, 1, 2, 4, 8))):
            for j in js:
                sc = k5_scal(W, j)
                fn = ((lambda j=j, sc=sc: lz.iter_step(sc, W[j], W[:j], d))
                      if name == "K5" else
                      (lambda j=j: lz.pass1_iso2d(s1, W[j], W[:j], d)))
                g = cs.graph_ms(torch, fn, 20)
                emit(kernel=f"{name} launch", n=n, j=j, launch_graph_ms=g,
                     bound_ms=cs.bound_ms((j + 2) * col))
        del W
        torch.cuda.empty_cache()

    # K1 / K1': one launch at j = 0 and at j = m - 2
    for n in ((1024, 4096) if "k1" in parts else ()):
        dx = 2.0 * LX / (n - 1)
        desc = operators.laplacian_2d((n, n), dx, dx, device=dev).kernel_desc
        c = torch.from_numpy((1.0 + 0.4 * np.random.default_rng(0).random(
            (n, n))).astype(np.float32))
        desc_a = operators.anisotropic_laplacian_2d(
            c, dx, dx, device=dev).kernel_desc
        col = 2 * n * n * 4
        W = [field(n) for _ in range(max(ms) - 1)]
        s1 = torch.tensor([[0.8, 0.3]], device=dev)
        for j in sorted({0} | {m - 2 for m in ms}):
            for name, fn_k, d, wbytes in (
                    ("K1", lz.pass1_iso2d, desc, 0),
                    ("K1'", lz.pass1_aniso2d, desc_a, 2 * n * n * 4)):
                readings(name, n, None, lambda fn_k=fn_k, d=d, j=j: fn_k(
                    s1, W[j], W[:j], d), (j + 2) * col + wbytes, 1,
                    200 if n == 1024 else 20, dict(j=j))
        del W
        torch.cuda.empty_cache()

    # the step's epilogue: both half kicks and the ghost copy
    def epilogues(shape, mshape=None):
        """{name: fn} of the epilogue of one SS2 step on the grid `shape`,
        split into blocks over `mshape` (every shard's work in one fn): the
        tree's own (two kick_bc launches where the tree has them, else the
        eager ops), and on a tree with kick_bc also the eager ops and each
        kick_bc launch alone."""
        from nlsolvers_tpu_torch.models import nlse
        from nlsolvers_tpu_torch.models.nonlinearities import (
            nlse_density_planar)
        from nlsolvers_tpu_torch.ops import boundaries
        from nlsolvers_tpu_torch.ops.cuda import bc3d as b3
        mshape = mshape or (1,) * len(shape)
        blk = tuple(g // k for g, k in zip(shape, mshape))
        R, nx = int(np.prod(blk[:-1])), blk[-1]
        pos = list(np.ndindex(*mshape))
        offs = [tuple(int(p * n) for p, n in zip(ps, blk)) for ps in pos]
        ups = [field(nx, rows=R) for _ in pos]
        rho = nlse_density_planar("cubic", torch.ones((R, nx), device=dev))
        th = 0.5 * DT
        sharded = len(pos) > 1
        if len(shape) == 3:
            def copy(outs):
                for u, o in zip(outs, offs):
                    b3.neumann_bc_planar_3d(u, blk, shape if sharded else None,
                                            o if sharded else None)
        elif sharded:             # the sharded step's where-masks
            from nlsolvers_tpu_torch.parallel import mesh as pmesh
            from nlsolvers_tpu_torch.parallel import spatial
            copy = spatial.sharded_neumann_2d(shape, pmesh.make_mesh(
                ("gy", "gx"), mshape, devices=[dev] * len(pos)))
        else:
            def copy(outs):
                return [boundaries.neumann_no_velocity_2d(u) for u in outs]

        def eager():
            for u in ups:
                nlse.phase_kick_planar(u, rho(u), th)
            copy([nlse.phase_kick_planar(u, rho(u), th) for u in ups])

        if not has_kick:
            return {"epilogue": eager}
        from nlsolvers_tpu_torch.ops.cuda import kick as kb
        grids = [kb.kick_grid(blk, shape if sharded else None,
                              o if sharded else None) for o in offs]

        def fused():
            for u, g in zip(ups, grids):
                kb.phase_kick_bc_planar(u, rho, th)
                kb.phase_kick_bc_planar(u, rho, th, g)

        def ghost():
            for u, g in zip(ups, grids):
                kb.phase_kick_bc_planar(u, rho, th, g)

        def kick_only():
            for u in ups:
                kb.phase_kick_bc_planar(u, rho, th)

        return {"epilogue": fused, "eager kicks + ghost copy": eager,
                "kick_bc with the copy": ghost, "kick_bc alone": kick_only}

    for shape, mshape in (((1024, 1024), None), ((4096, 4096), None),
                          ((128,) * 3, None), ((256,) * 3, None),
                          ((4096, 4096), (2, 2)), ((512,) * 3, (2, 2, 2))):
        if "kickbc" not in parts:
            break
        cells = int(np.prod(shape))
        n_sh = int(np.prod(mshape or 1))
        tag = "x".join(map(str, shape)) + (
            "" if mshape is None else " on " + "x".join(map(str, mshape)))
        reps = 20 if cells <= 128 ** 3 else 5
        for name, fn in epilogues(shape, mshape).items():
            kicks = 1 if name.startswith("kick_bc") else 2
            # the profiler's kernel rows, launches and ms per call each
            rows = cs.profiled(torch, lambda fn=fn: [fn() for _ in
                                                      range(reps)]) or []
            kernel_rows = {e.key[:70]: [e.count / reps,
                                        cs.dev_us(e) / 1e3 / reps]
                           for e in rows if cs.dev_us(e) > 0}
            readings(name, tag, None, fn, 20 * cells * kicks, kicks * n_sh,
                     reps, dict(kick_bc_tree=has_kick,
                                profiler_rows=kernel_rows))
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
        if "rates" not in parts:
            break
        label = f"[{args.tag}] rate {label}"
        cs.rate(torch, {label: problem(n, integ, aniso)}, chunk, [label] * 3,
                5)
        torch.cuda.empty_cache()

    def sharded(global_shape, mshape, variant):
        """The sharded SS2 step with every shard on this card, as a problem
        for chip_smoke's rate: its state is a tuple of the shards' blocks."""
        import math

        from nlsolvers_tpu_torch.parallel import mesh as pmesh
        from nlsolvers_tpu_torch.parallel import shards, spatial
        axes = ("gy", "gx") if len(global_shape) == 2 else ("gz", "gy", "gx")
        mesh = pmesh.make_mesh(axes, mshape,
                               devices=[dev] * math.prod(mshape))
        step = spatial.make_sharded_nlse_step(
            "cubic", global_shape, LX, DT, mesh, axis_names=axes,
            krylov_m=10, variant=variant)
        x = torch.linspace(-LX, LX, global_shape[-1], dtype=torch.float32,
                           device=dev)
        g = torch.meshgrid(*([x] * len(global_shape)), indexing="ij")
        env = torch.exp(-sum(a * a for a in g) / 4)
        u0 = torch.stack([env * torch.cos(0.5 * g[-1]),
                          env * torch.sin(0.5 * g[-1])])
        mp = shards.shard(torch.ones(global_shape, device=dev), mesh)

        def stp(s, i):
            del i
            return tuple(step(list(s), mp))

        return (SimpleNamespace(step=stp),
                tuple(shards.shard(u0, mesh)))

    for shape, mshape, variant, chunk, n_prof in (
            ((4096, 4096), (2, 2), "reference", 20, 5),
            ((512,) * 3, (2, 2, 2), "clean", 5, 2)):
        if "shard" not in parts:
            break
        label = (f"[{args.tag}] rate sharded {shape[0]}^{len(shape)} on "
                 f"{mshape}")
        cs.rate(torch, {label: sharded(shape, mshape, variant)}, chunk,
                [label] * 3, n_prof)
        torch.cuda.empty_cache()

    # the opt-in paths beside their defaults, chunks interleaved
    def with_switches(prob, **sw):
        def step(s, i):
            old = interop.set_switches(**sw)
            try:
                return prob.step(s, i)
            finally:
                interop.set_switches(**old)
        return dataclasses.replace(prob, step=step)

    def problem2d(n, resident):
        old = interop.set_switches(resident_mode="auto" if resident else "off")
        try:
            prob = problems.nlse_problem("cubic", (n, n), LX, dt_theta(n),
                                         m_field=torch.ones((n, n)),
                                         krylov_m=10, dtype=torch.complex64)
        finally:
            interop.set_switches(**old)
        g = gaussian(n)
        return prob, prob.init(g if prob.meta["planar_state"]
                               else torch.complex(g[0], g[1]))

    def problem3d(n):
        prob = problems.nlse_problem("cubic", (n, n, n), LX, DT,
                                     m_field=torch.ones((n, n, n)),
                                     krylov_m=10)
        x = torch.linspace(-LX, LX, n, dtype=torch.float32, device=dev)
        Z, Y, X = torch.meshgrid(x, x, x, indexing="ij")
        env = torch.exp(-(X ** 2 + Y ** 2 + Z ** 2) / 4)
        return prob, prob.init(torch.stack([env * torch.cos(0.5 * X),
                                            env * torch.sin(0.5 * X)]))

    for n, chunk, n_prof in ((128, 100, 20), (256, 20, 5)):
        if "rates3d" not in parts:
            break
        label = f"[{args.tag}] rate {n}^3 iso SS2"
        cs.rate(torch, {label: problem3d(n)}, chunk, [label] * 3, n_prof)
        torch.cuda.empty_cache()

    for n, chunk, n_prof in ((1024, 200, 20), (4096, 20, 5)):
        if "optin" not in parts:
            break
        ro, rd, rf = (f"[{args.tag}] rate {k} {n}^2" for k in (
            "resident", "default", "fused_iter"))
        runs = {ro: problem2d(n, True), rd: problem2d(n, False)}
        order = [rd, ro, ro, rd, rd, ro]
        if n == 1024:                   # K5's path, which FUSED_ITER_BYTES
            prob, s0 = runs[rd]         # admits up to 2048^2
            runs[rf] = (with_switches(prob, fused_iter=True), s0)
            order = [rd, ro, rf, rf, ro, rd, rd, rf, ro]
        cs.rate(torch, runs, chunk, order, n_prof)
        torch.cuda.empty_cache()
    for n, chunk, n_prof in ((128, 100, 20), (256, 20, 5)):
        if "optin" not in parts:
            break
        prob, s0 = problem3d(n)
        po, pd, pf = (f"[{args.tag}] rate {k} {n}^3" for k in (
            "pipeline_3d", "two-pass", "fused_iter"))
        runs = {po: (with_switches(prob, pipeline_3d=True), s0),
                pd: (prob, s0)}
        order = [pd, po, po, pd, pd, po]
        if n == 128:                    # K5's 3D path (16.8 MB fields)
            runs[pf] = (with_switches(prob, fused_iter=True), s0)
            order = [pd, po, pf, pf, po, pd, pd, pf, po]
        cs.rate(torch, runs, chunk, order, n_prof)
        del prob, s0
        torch.cuda.empty_cache()
    # the datagen production point (benchmarks/datagen_bench.py:22-26):
    # cubic NLSE 256^2, Lx = 10, T = 1.2, nt = 2000, 128 snapshots, batch 8,
    # Krylov m = 20, c layered, m piecewise, multi_soliton
    if "datagen" in parts:
        import shutil

        from nlsolvers_tpu_torch.pipeline import datagen, engine, fields
        from nlsolvers_tpu_torch.pipeline.samplers.nlse2d import (
            NLSEPhenomenonSampler)
        n, m, B, nt, snaps = 256, 20, 8, 2000, 128
        dx = 2.0 * LX / (n - 1)
        # the kernels of one trajectory-step at 256^2 m=20, c(x)
        c = torch.from_numpy((1.0 + 0.4 * np.random.default_rng(0).random(
            (n, n))).astype(np.float32))
        desc_a = operators.anisotropic_laplacian_2d(
            c, dx, dx, device=dev).kernel_desc
        col, wbytes = 2 * n * n * 4, 2 * n * n * 4
        W = [field(n) for _ in range(m)]
        av = field(n)
        scs = []
        for j in range(m - 1):
            s = torch.rand((j + 2, 2), generator=gen, device=dev) - 0.5
            s[0, 0], s[0, 1] = 0.8, 0.0
            scs.append(s)
        s1 = torch.tensor([[0.8, 0.3]], device=dev)
        readings("K1' datagen", n, m, lambda: lz.pass1_aniso2d(
            s1, W[0], [], desc_a), 2 * col + wbytes, 1, 200)

        def k2_step():
            for j in range(m - 1):
                lz.pipe_aniso2d(scs[j], av, W[:j + 1], desc_a, j == m - 2)

        k2_cols = sum(j + 4 for j in range(m - 2)) + m + 1
        readings("K2' datagen", n, m, k2_step,
                 k2_cols * col + (m - 2) * wbytes, m - 1, 50)
        q = torch.rand((1, m, 2), generator=gen, device=dev) - 0.5
        Wc = torch.stack([torch.complex(w[0], w[1]).reshape(-1) for w in W])
        qc = torch.complex(q[..., 0], q[..., 1])
        mm = {"matmul_graph_ms": cs.graph_ms(
            torch, lambda: torch.matmul(qc, Wc), 200),
              "matmul_profiler_ms": cs.times_ms(
                  torch, lambda: torch.matmul(qc, Wc), 200)[0]}
        readings("K3 datagen", n, m, lambda: lz.combine(q, W), (m + 1) * col,
                 1, 200, mm)
        if has_kick:
            readings("kick_bc datagen", n, None,
                     epilogues((n, n))["epilogue"], 20 * n * n * 2, 2, 200)
        del W, av, Wc
        torch.cuda.empty_cache()
        if hasattr(operators, "batched_aniso_laplacian_2d"):
            for key, r in cs.batched_parity(torch, np, operators).items():
                prof, events, plain = r["t"]
                bound = cs.bound_ms(r["nbytes"])
                emit(kernel=f"{key} batched datagen", n=n, m=m, batch=B,
                     launches=r["launches"], graph_ms=r["graph"],
                     unbatched_lanes_graph_ms=r["lanes_graph"],
                     profiler_ms=prof, events_ms=events, plain_ms=plain,
                     library_graph_ms=r["lib"], bound_ms=bound,
                     mbytes=r["nbytes"] / 1e6, share_graph=bound / r["graph"])

        # the engine as benchmarks/datagen_bench.py drives JAX's: B lanes
        # sampled with its seeds, guard off, timed dispatch to readback,
        # the better of two calls (nothing compiles: the kernels are built)
        rng = np.random.default_rng(0)
        sampler = NLSEPhenomenonSampler(n, n, LX, seed=0)
        u0s, ms_, cs_ = [], [], []
        for _ in range(B):
            u0 = np.asarray(sampler.generate_sample("multi_soliton"))
            u0s.append(u0 / max(np.abs(u0).max(), 1e-12))
            c_f, _ = fields.sample_c_field(sampler.grid, rng, kind="layered")
            m_f, _ = fields.sample_m_field(sampler.grid, rng,
                                           kind="piecewise", c=c_f)
            ms_.append(m_f)
            cs_.append(c_f)
        u0 = np.stack(u0s)
        packed = np.stack([u0.real, u0.imag], axis=1).astype(np.float32)
        m_b = np.stack(ms_).astype(np.float32)
        c_b = np.stack(cs_).astype(np.float32)
        freq = nt // snaps
        steps = (snaps - 1) * freq
        fn = engine.make_nlse_trajectory_fn("cubic", (n, n), LX, 1.2 / nt,
                                            krylov_m=m)
        assert fn.planar
        walls = []
        for rep in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(packed, m_b, c_b, snaps, freq).cpu().numpy()
            walls.append(time.perf_counter() - t1)
        assert np.isfinite(out).all() and out.shape == (B, snaps, 2, n, n)
        best = min(walls)
        emit(datagen="engine", n=n, m=m, batch=B, nt=nt, snapshots=snaps,
             steps=steps, walls_s=walls, best_s=best,
             trajectories_per_min=B / best * 60.0,
             trajectory_steps_per_s=B * steps / best)
        # one batched step's device profile: 20 steps inside one call
        n_b = 20
        fn(packed, m_b, c_b, 2, 1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn(packed, m_b, c_b, 2, n_b)
        torch.cuda.synchronize()
        wall_step = (time.perf_counter() - t1) / n_b
        n_p = 5
        rows = cs.profiled(torch, lambda: fn(packed, m_b, c_b, 2, n_p))
        busy = (sum(cs.dev_us(e) for e in rows) / 1e3 / n_p
                if rows is not None else None)
        launched = (sum(e.count for e in rows if cs.dev_us(e) > 0) / n_p
                    if rows is not None else None)
        top = ({e.key[:70]: [e.count / n_p, cs.dev_us(e) / 1e3 / n_p]
                for e in sorted(rows, key=cs.dev_us, reverse=True)[:8]}
               if rows is not None else None)
        syncs = cs.host_syncs(torch, lambda: fn(packed, m_b, c_b, 2, 1))
        # the same with the inputs already on the card (no upload), over 1
        # and 5 steps: the syncs of the steps themselves
        on_card = [torch.from_numpy(a).to(dev) for a in (packed, m_b, c_b)]
        s1, s5 = (cs.host_syncs(torch, lambda k=k: fn(*on_card, 2, k))
                  for k in (1, 5))
        emit(datagen="batched step", n=n, m=m, batch=B,
             wall_ms=wall_step * 1e3, busy_ms=busy,
             idle_share=(None if busy is None
                         else 1 - busy / (wall_step * 1e3)),
             launches_per_batched_step=launched,
             launches_per_trajectory_step=(None if launched is None
                                           else launched / B),
             host_syncs_per_call_of_one_step=syncs,
             host_syncs_per_batched_step=(s5 - s1) / 4,
             host_syncs_one_step_inputs_on_card=s1, top_kernels=top)
        del out
        torch.cuda.empty_cache()

        # the sweep end to end through Datagen (the CLI's path: samplers
        # and spaces, guard on, npy archive through the native writer)
        work = Path(args.root) / "_smoke_datagen"
        shutil.rmtree(work, ignore_errors=True)
        cfg = datagen.DatagenConfig(
            family="nlse", phenomenon="multi_soliton", system="cubic", nx=n,
            Lx=LX, T=1.2, nt=nt, snapshots=snaps, num_runs=B, batch_size=B,
            anisotropy_type="layered", m_type="piecewise",
            archive_format="npy", output_dir=str(work))
        dgen = datagen.Datagen(cfg)
        t1 = time.perf_counter()
        written = dgen.run()
        wall = time.perf_counter() - t1
        st = dgen.last_stats
        emit(datagen="sweep", n=n, m=m, batch=B, nt=nt, snapshots=snaps,
             archived=len(written), wall_s=wall, sample_s=st["sample_s"],
             evolve_s=st["evolve_s"], archive_s=st["archive_s"],
             trajectories_per_min=len(written) / wall * 60.0,
             trajectory_steps_per_s=len(written) * steps / wall)
        shutil.rmtree(work, ignore_errors=True)
    if "run3d" in parts:
        import statistics
        n = 128
        d3 = operators.laplacian_3d((n, n, n), 2.0 * LX / (n - 1),
                                    device=dev).kernel_desc
        u = field(n, rows=n * n)

        def run():
            lz.lanczos_planar(u, d3, 10)

        for _ in range(5):
            run()
        torch.cuda.synchronize()
        hosts, walls = [], []
        for _ in range(40):
            t1 = time.perf_counter()
            run()
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            hosts.append((t2 - t1) * 1e3)
            walls.append((time.perf_counter() - t1) * 1e3)
        rows = cs.profiled(torch, lambda: [run() for _ in range(10)])
        emit(run3d=f"{n}^3 iso m=10", host_ms=statistics.median(hosts),
             wall_ms=statistics.median(walls),
             graph_ms=cs.graph_ms(torch, run, 20),
             kernels=None if rows is None else {
                 e.key[:90]: [e.count / 10, cs.dev_us(e) / 1e3 / 10]
                 for e in sorted(rows, key=cs.dev_us, reverse=True)[:8]})
    if "sweeps" in parts:
        import shutil

        from nlsolvers_tpu_torch.pipeline import datagen
        work = Path(args.root) / "_smoke_datagen"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir()
        for label, r in cs.datagen_rates(torch, np, datagen, work).items():
            emit(datagen_sweep=label, **r)
        shutil.rmtree(work, ignore_errors=True)
    if "shard-datagen" in parts:
        shard_datagen(cs, torch, np, dev, emit)
    if "shard3d-bricks" in parts:
        shard3d_bricks(cs, torch, dev, emit)
    if args.out:
        with open(args.out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return 0


def shard3d_bricks(cs, torch, dev, emit):
    """The shard3d-bricks part (module docstring)."""
    import math

    from nlsolvers_tpu_torch.ops.cuda import lanczos3d as l3

    gen = torch.Generator(device=dev).manual_seed(246)
    m = 10
    for label, kind, lshape, mshape, B in (
            ("batched c(x)", "shard3d_aniso", (256, 256, 64), (1, 1, 4), 2),
            ("batched iso", "shard3d", (256, 256, 64), (1, 1, 4), 2),
            ("512^3 c(x)", "shard3d_aniso", (256, 256, 256), (2, 2, 2), 1)):
        n = lshape[-1] * mshape[-1]
        descs = [d for d, _ in cs.shard_lane_descs(
            torch, kind, lshape, mshape, ((n - 1) / (2 * LX)) ** 2, B, gen)]
        rows = math.prod(lshape[:-1])
        hs = [cs.shard_halos(torch, lshape, 2, B, gen) for _ in descs]
        Ws = [[torch.randn((B, 2, rows, lshape[-1]), generator=gen,
                           device=dev) for _ in range(m - 1)] for _ in descs]
        s = torch.tensor([[[0.5, 0.0]]], device=dev).expand(B, 1, 2)
        s = s.contiguous()
        if B == 1:
            descs = [dict(d, **{k: v[0] for k, v in d.items()
                                if k.startswith("w")}) for d in descs]
            hs = [[x[0] for x in h] for h in hs]
            Ws = [[w[0] for w in W] for W in Ws]
            s = s[0]
        col = B * 2 * math.prod(lshape) * 4
        halo = sum(x.numel() for x in hs[0]) * 4
        wts = sum(v.numel() for k, v in descs[0].items()
                  if k.startswith("w")) * 4
        nbytes = len(descs) * sum((j + 2) * col + halo + wts
                                  for j in range(m - 1))
        aniso = kind.endswith("aniso")
        base = l3.shard3d_tiles(*lshape, 2, aniso, 1)
        cands = [base] + [dict(base, pz=pz) for pz in (4, 8, 16, 32, 64)
                          if pz != base["pz"]]
        step = max(1, 128 // base["nxt"])       # rows: threads of 32
        cands += [dict(base, nxt=base["nxt"] // 2, tyt=base["tyt"] * 2),
                  dict(base, tyt=base["tyt"] // 2 // step * step)]
        picker = l3.shard3d_tiles
        for t in cands:
            def run(Ws=Ws, hs=hs, descs=descs):
                for W, h, d in zip(Ws, hs, descs):
                    for j in range(m - 1):
                        l3.pass1_shard3d(s, W[j], W[:j], *h, d)
            l3.shard3d_tiles = lambda *a, t=t: t
            try:
                g = cs.graph_ms(torch, run, 5)
            finally:
                l3.shard3d_tiles = picker
            emit(shard3d_bricks=label, lshape=list(lshape), mesh=list(mshape),
                 lanes=B, m=m, nxt=t["nxt"], tyt=t["tyt"], pz=t["pz"],
                 picked=t is base, graph_ms=g, bound_ms=cs.bound_ms(nbytes),
                 bytes=nbytes, bound_share=cs.bound_ms(nbytes) / g)
        del Ws, hs, descs
        torch.cuda.empty_cache()


def shard_datagen(cs, torch, np, dev, emit):
    """The shard-datagen part (module docstring)."""
    import math

    from nlsolvers_tpu_torch.ops.cuda import lanczos2d as lz
    from nlsolvers_tpu_torch.ops.cuda import lanczos3d as l3
    from nlsolvers_tpu_torch.parallel import mesh as pmesh
    from nlsolvers_tpu_torch.parallel import shards, spatial

    gen = torch.Generator(device=dev).manual_seed(135)
    # unbatched, per step of the sharded main paths (m = 10)
    m = 10
    for key, kern, kind, lshape, mshape in (
            ("pass1_shard2d reference", lz.pass1_shard2d, "shard2d",
             (2048, 2048), (2, 2)),
            ("pass1_shard2d aniso", lz.pass1_shard2d, "shard2d_aniso",
             (2048, 2048), (2, 2)),
            ("pass1_shard3d clean", l3.pass1_shard3d, "shard3d",
             (256, 256, 256), (2, 2, 2)),
            ("pass1_shard3d aniso", l3.pass1_shard3d, "shard3d_aniso",
             (256, 256, 256), (2, 2, 2))):
        n = lshape[-1] * mshape[-1]
        descs = [lanes[0] for _, lanes in cs.shard_lane_descs(
            torch, kind, lshape, mshape, ((n - 1) / (2 * LX)) ** 2, 1, gen)]
        if kind == "shard3d":
            descs = [dict(d, variant="clean") for d in descs]
        rows = math.prod(lshape[:-1])
        hs = [[h[0] for h in cs.shard_halos(torch, lshape, 2, 1, gen)]
              for _ in descs]
        Ws = [[torch.randn((2, rows, lshape[-1]), generator=gen, device=dev)
               for _ in range(m - 1)] for _ in descs]
        s = torch.tensor([[0.5, 0.0]], device=dev)

        def run(Ws=Ws, hs=hs, descs=descs, kern=kern):
            for W, h, d in zip(Ws, hs, descs):
                for j in range(m - 1):
                    kern(s, W[j], W[:j], *h, d)

        col = 2 * math.prod(lshape) * 4
        halo = sum(x.numel() for x in hs[0]) * 4
        wts = sum(v.numel() for k, v in descs[0].items()
                  if k.startswith("w")) * 4
        nbytes = len(descs) * sum((j + 2) * col + halo + wts
                                  for j in range(m - 1))
        g = cs.graph_ms(torch, run, 3)
        prof, events = cs.times_ms(torch, run, 3)
        emit(shard_kernel=key, lshape=list(lshape), mesh=list(mshape), m=m,
             launches=len(descs) * (m - 1), graph_ms=g, profiler_ms=prof,
             events_ms=events, bound_ms=cs.bound_ms(nbytes),
             bytes=nbytes, bound_share=cs.bound_ms(nbytes) / g)
        del Ws, hs, descs
        torch.cuda.empty_cache()
    # batched, per batched sharded Lanczos run at the datagen-shard points
    for key, r in cs.batched_parity_shard(torch, np).items():
        emit(shard_kernel=f"{key} batched", lanes=cs.SH_B,
             launches=r["launches"], graph_ms=r["graph"],
             lanes_graph_ms=r["lanes_graph"], profiler_ms=r["t"][0],
             events_ms=r["t"][1], plain_ms=r["t"][2],
             bound_ms=cs.bound_ms(r["nbytes"]), bytes=r["nbytes"],
             bound_share=cs.bound_ms(r["nbytes"]) / r["graph"])

    # the batched sharded step beside the lanes through the unbatched step
    def lanes_in_turn(stepfn, mp, cp, n_sh):
        """The B lanes' shard lists as one flat tuple, each lane stepped
        alone through make_sharded_nlse_step."""
        def step(s, i):
            del i
            out = []
            for b in range(len(mp)):
                out += stepfn(list(s[b * n_sh:(b + 1) * n_sh]), mp[b], cp[b])
            return tuple(out)
        return SimpleNamespace(step=step)

    for shape, mshape, m_, dt, B, chunk in (
            ((1024, 1024), (2, 2), 20, 1.2 / 2000, 2, 20),
            ((1024, 1024), (2, 2), 20, 1.2 / 2000, 8, 10),
            ((256, 256, 256), (1, 1, 4), 10, 0.048 / 80, 2, 10)):
        axes = ("gy", "gx") if len(shape) == 2 else ("gz", "gy", "gx")
        mesh = pmesh.make_mesh(axes, mshape,
                               devices=[dev] * math.prod(mshape))
        x = torch.linspace(-LX, LX, shape[-1], device=dev)
        grids = torch.meshgrid(*([x] * len(shape)), indexing="ij")
        r2 = sum(g * g for g in grids)
        u0 = torch.stack([torch.stack([torch.exp(-r2 / (4 + b)) * torch.cos(
            0.5 * grids[-1]), torch.exp(-r2 / (4 + b)) * torch.sin(
            0.5 * grids[-1])]) for b in range(B)])
        del grids, r2
        mf = torch.ones((B,) + shape, device=dev)
        c = 1.0 + 0.4 * torch.rand((B,) + shape, generator=gen, device=dev)
        step_of = spatial._planar_nlse(
            "cubic", shape, LX, dt, mesh, axes, "ss2", 1.0, -0.1, 1.0, m_,
            "reference", True, True)
        mp, cp = shards.shard(mf, mesh, axes), shards.shard(c, mesh, axes)
        bstep = step_of(mp, cp)
        batched = SimpleNamespace(step=lambda s, i, f=bstep: tuple(
            f(list(s), i)))
        s_b = tuple(p.reshape((B, 2) + step_of.block)
                    for p in shards.shard(u0, mesh, axes))
        one = spatial.make_sharded_nlse_step(
            "cubic", shape, LX, dt, mesh, axis_names=axes, krylov_m=m_,
            use_c=True)
        mpl = [shards.shard(mf[b], mesh, axes) for b in range(B)]
        cpl = [shards.shard(c[b], mesh, axes) for b in range(B)]
        lanes = lanes_in_turn(one, mpl, cpl, mesh.size)
        s_l = tuple(p for b in range(B)
                    for p in shards.shard(u0[b], mesh, axes))
        tag = f"{'x'.join(map(str, shape))} on {mshape} m={m_} B={B}"
        print(f"[shard-datagen] batched sharded SS2 step vs the lanes in "
              f"turn, {tag}:")
        cs.rate(torch, {f"batched {tag}": (batched, s_b),
                        f"lanes {tag}": (lanes, s_l)}, chunk,
                [f"batched {tag}", f"lanes {tag}", f"lanes {tag}",
                 f"batched {tag}"], 3)
        emit(shard_step=tag, printed="above (chip_smoke.rate)")
        del u0, mf, c, mp, cp, s_b, s_l, mpl, cpl
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
