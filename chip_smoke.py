#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

Run from the repository root: `python3 chip_smoke.py`. Needs one CUDA card,
nvcc (the kernels are built from nlsolvers_tpu_torch/csrc at first use) and
nvidia-smi. Imports torch, numpy and nlsolvers_tpu_torch only, never JAX.

Phases, one line each (or a few):
  1. device    the card's name and `nvidia-smi` name, power limit
  2. build     one nvcc per csrc/*.cu, all started together; seconds,
               registers and spills from ptxas
  3. parity    each 2D kernel (K1-K3) against its plain PyTorch version on
               the same seeded CUDA tensors, at 1024^2 complex64 and on a
               ragged 250x333 grid: fields rel-L2 <= 1e-5 (same elementwise
               arithmetic up to FMA contraction); reduced dots
               |got - want| <= 1e-4 * ||a|| ||b|| (summation order differs).
               Times at the main path's shapes: device time of the
               launched kernels (torch.profiler) and wall time by CUDA
               events, which include the host's enqueue, over 20 calls.
  4. main      nlse_problem("cubic", (1024, 1024), 10, 1e-4, m=10) through
               problems.run: 200 steps, exactly 1 K1 + 9 K2 + 1 K3 launches
               per step, finite snapshots, relative mass drift < 1e-3.
  5. paths     20 steps with the kernels vs the plain planar versions
               (rel-L2 <= 1e-5), and the plain planar path vs the complex
               ss2_step path (rel-L2 <= 2e-4, the gate of
               tests/test_pallas.py).
  6. rate      steps/s: median of 3 chunks of 200 steps, synchronized; the
               device's busy time per step from torch.profiler, and the host
               syncs one step makes.
  7. parity3d  the 3D kernels (pass1_3d, pass2, bc3d) against their plain
               versions at 128^3 and on a ragged 37x50x61 grid, the iso
               reference, iso clean and aniso operators, j in {0, 4, 8}:
               the same gates, and bc3d exactly equal. Times at 128^3 per
               step of the main path, beside the one-call PyTorch yardsticks
               (torch.matmul for combine, torch.addmm for pass2).
  8. main3d    nlse_problem("cubic", (128, 128, 128), 10, 1e-4, m=10): 200
               steps with exactly 9 pass1_3d + 9 pass2 + 1 combine + 1 bc3d
               launches per step, finite snapshots, mass drift < 1e-3; then
               with c(x) = 1 + 0.4 U[0, 1) for 100 steps, same gates.
  9. paths3d   20 steps, iso and c(x): kernels vs plain planar (<= 1e-5),
               plain planar vs complex ss2_step (<= 2e-4).
 10. rate3d    steps/s at 128^3 iso (5 chunks of 100) and 128^3 c(x) (3 of
               100), their chunks interleaved, and 256^3 iso (3 of 20), each
               with device busy ms per step, idle share, launches and host
               syncs per step; at 128^3 also the host's own profile.
Then the card's name and power limit, the kernels as one JSON line, and last
{"ok": true, "device": ...}. Any failed phase exits non-zero and prints no
result.
"""

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

N, LX, DT, KRYLOV_M = 1024, 10.0, 1e-4, 10
N3, N3_BIG = 128, 256
FIELD_TOL, DOT_TOL = 1e-5, 1e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
SOURCE = "nlsolvers_tpu_torch/csrc/lanczos2d.cu"
SOURCE3 = "nlsolvers_tpu_torch/csrc/lanczos3d.cu"
PALLAS = "nlsolvers_tpu/ops/pallas/lanczos2d.py"
PALLAS3 = "nlsolvers_tpu/ops/pallas/lanczos3d_pipe.py"
PALLAS_BC = "nlsolvers_tpu/ops/pallas/bc3d.py"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rel(a, b):
    return float((a - b).norm() / b.norm())


def dot_err(got, want, lefts, right):
    """max_i |got_i - want_i| / (||a_i|| ||b||) over a (k, 2) dot array."""
    rn = float(right.norm())
    return max(float((got[i] - want[i]).abs().max())
               / (float(a.norm()) * rn) for i, a in enumerate(lefts))


def dev_us(e):
    """Device time of a profiler row that is a kernel, in microseconds; 0
    for host-op rows, whose device time repeats that of their kernels."""
    from torch.autograd import DeviceType
    if getattr(e, "device_type", None) != DeviceType.CUDA:
        return 0
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0) or 0)


def profiled(torch, fn, tries=3):
    """torch.profiler's key_averages() over fn(); profiled again, up to
    `tries` times, when the trace holds no kernel rows (the profiler drops a
    trace now and then: one of ~600 in this script's runs). Fails if every
    try comes back empty."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        if any(dev_us(e) > 0 for e in rows):
            return rows
    raise SmokeFailure(f"torch.profiler recorded no device time in {tries} "
                       f"tries")


def times_ms(torch, fn, reps=20):
    """(device, wall) ms per call of fn: the summed device time of the
    kernels it launches (torch.profiler), and CUDA events around each call,
    median, which include the host's enqueue time when that is longer."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        walls.append(a.elapsed_time(b))
    def batch():
        for _ in range(reps):
            fn()

    device = sum(dev_us(e) for e in profiled(torch, batch)) / 1e3 / reps
    return device, statistics.median(walls)


def kernel_name(mangled):
    """name<template args> of a mangled kernel whose name ends in _kernel or
    _partials; the name is the length-prefixed identifier before that end."""
    import re
    m = re.search(r"(_kernel|_partials)(I(?:L[ib]\d+E)+E)?", mangled)
    if not m:
        return mangled[:40]
    end = m.end(1)
    name = mangled[:end]
    for j in range(end - 1, 0, -1):
        digits = re.search(r"\d{1,3}$", mangled[:j])
        if digits and int(digits.group()[-len(str(end - j)):]) == end - j:
            name = mangled[j:end]
            break
    if m.group(2):
        name += "<" + ", ".join(re.findall(r"L[ib](\d+)E", m.group(2))) + ">"
    return name


def spilling_kernels(lines):
    """The kernels that ptxas -v reports spilling registers, from a build
    log's lines, each with its spill stores."""
    out, fn = [], ""
    for ln in lines:
        if "Function properties for" in ln:
            fn = ln.split("Function properties for")[1].strip()
        elif "spill stores" in ln and " 0 bytes spill stores" not in ln:
            out.append(f"{kernel_name(fn)} "
                       f"({ln.strip().split(',')[1].strip()})")
    return out


def bound_ms(nbytes):
    """Least time for `nbytes` of device-memory traffic at the data-sheet
    rate (every kernel here is bound by bytes, not operations)."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def advance(step, s, n):
    for i in range(1, n + 1):
        s = step(s, i)
    return s


def host_syncs(torch, fn):
    """Host syncs that fn() makes (torch.cuda sync debug mode)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def rate(torch, runs, chunk, order, n_prof, host_profile=False):
    """Steps/s of one or more problems, each the median of its synchronized
    chunks of `chunk` steps, taken in the interleaved `order` of run labels
    (so that host drift falls on all runs alike). Then per run:
    torch.profiler over n_prof steps (device busy ms/step, idle share,
    launches per step, the top kernels), the host syncs of one step and,
    with host_profile, the host functions that take the most time (cProfile
    over n_prof steps). runs: {label: (problem, state)}."""
    state = {k: advance(p.step, s, 3) for k, (p, s) in runs.items()}
    torch.cuda.synchronize()
    rates = {k: [] for k in runs}
    for k in order:
        t0 = time.perf_counter()
        state[k] = advance(runs[k][0].step, state[k], chunk)
        torch.cuda.synchronize()
        rates[k].append(chunk / (time.perf_counter() - t0))
    for label, (prob, _) in runs.items():
        s = state[label]
        check(bool(torch.isfinite(s).all()), f"{label}: non-finite state "
              f"after timing")
        r = rates[label]
        sps = statistics.median(r)
        print(f"{label}: {sps:.2f} steps/s median of {len(r)} x {chunk} "
              f"steps (min {min(r):.2f}, max {max(r):.2f}; in call order "
              f"{', '.join(f'{x:.1f}' for x in r)}); {1e3 / sps:.4f} ms/step")
        box = [s]

        def steps():
            box[0] = advance(prob.step, box[0], n_prof)

        rows = profiled(torch, steps)
        busy_ms = sum(dev_us(e) for e in rows) / 1e3 / n_prof
        launched = sum(e.count for e in rows if dev_us(e) > 0) / n_prof
        print(f"{label}: device busy {busy_ms:.4f} ms/step of "
              f"{1e3 / sps:.4f} ms/step -> idle share "
              f"{1 - busy_ms * sps / 1e3:.3f}; {launched:.0f} kernel "
              f"launches per step")
        for e in sorted(rows, key=dev_us, reverse=True)[:8]:
            print(f"  {dev_us(e) / 1e3 / n_prof:9.4f} ms/step "
                  f"{e.count // n_prof:4d}x/step {e.key[:70]}")

        def one_step():
            box[0] = prob.step(box[0], 1)

        print(f"{label}: host syncs in one step: "
              f"{host_syncs(torch, one_step)}")
        if host_profile:
            import cProfile
            import pstats
            torch.cuda.synchronize()
            prof_h = cProfile.Profile()
            prof_h.enable()
            s = advance(prob.step, box[0], n_prof)
            torch.cuda.synchronize()
            prof_h.disable()
            st = pstats.Stats(prof_h)
            total = st.total_tt / n_prof * 1e3
            print(f"{label}: host profile (cProfile, which slows the host): "
                  f"{total:.3f} ms/step; most self time:")
            top = sorted(st.stats.items(), key=lambda kv: kv[1][2],
                         reverse=True)[:10]
            for (fname, line, fn), (_, ncalls, tt, _, _) in top:
                where = f"{Path(fname).name}:{line}({fn})"
                print(f"  {tt / n_prof * 1e3:8.4f} ms/step "
                      f"{ncalls // n_prof:5d}x/step {where[:70]}")


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "nlsolvers_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no nlsolvers_tpu_torch package beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from nlsolvers_tpu_torch import config
    from nlsolvers_tpu_torch.models import nlse, problems
    from nlsolvers_tpu_torch.models.nonlinearities import nlse_density
    from nlsolvers_tpu_torch.ops import boundaries, operators
    from nlsolvers_tpu_torch.ops.cuda import _build
    from nlsolvers_tpu_torch.ops.cuda import bc3d as b3
    from nlsolvers_tpu_torch.ops.cuda import lanczos2d as lz
    from nlsolvers_tpu_torch.ops.cuda import lanczos3d as l3

    check("jax" not in sys.modules, "jax was imported")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls must stay off (torch default)")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ---------------------------------------------------------- 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"device: {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    print(smi_line)

    # ---------------------------------------------------------- 2. build
    libs = ("lanczos2d", "lanczos3d")
    _build.build_all(libs)
    for lib in libs:
        log = _build.build_log(lib)
        lines = log.read_text().splitlines() if log.exists() else []
        spills = spilling_kernels(lines)
        regs = [int(ln.split("Used ")[1].split(" registers")[0])
                for ln in lines if "registers" in ln and "Used " in ln]
        print(f"build {lib}: {_build.build_seconds(lib):.2f} s (nvcc sm_90a "
              f"and load, builds in parallel); {len(regs)} kernels, "
              f"registers {min(regs, default=0)}-{max(regs, default=0)}; "
              f"kernels that spill registers: {len(spills)} "
              f"{'; '.join(spills)}")

    # ---------------------------------------------------------- 3. parity
    gen = torch.Generator(device=dev).manual_seed(1234)

    def field(ny=N, nx=N, P=2):
        return torch.randn((P, ny, nx), generator=gen, device=dev)

    def scalars(rows):
        s = torch.rand((rows, 2), generator=gen, device=dev) - 0.5
        s[0, 0], s[0, 1] = 0.8, 0.0
        return s

    def both(fn):
        got = fn()
        config.kernel_mode = "off"
        try:
            want = fn()
        finally:
            config.kernel_mode = "auto"
        return got, want

    def gate(label, fe, de):
        torch.cuda.synchronize()
        print(f"parity {label}: field rel-L2 {fe:.3e}, dot err {de:.3e}")
        check(fe <= FIELD_TOL, f"{label}: field rel-L2 {fe:.3e} > {FIELD_TOL}")
        check(de <= DOT_TOL, f"{label}: dot error {de:.3e} > {DOT_TOL}")

    dx = 2.0 * LX / (N - 1)
    desc = operators.laplacian_2d((N, N), dx, dx, device=dev).kernel_desc
    errs = {k: 0.0 for k in ("K1", "K2", "K3", "pass1_3d", "pass2", "bc3d")}

    def parity_pass1(j, d, ny, nx, P=2):
        W = [field(ny, nx, P) for _ in range(j + 1)]
        scal = scalars(1)
        (w, raw), (w0, raw0) = both(
            lambda: lz.pass1_iso2d(scal, W[j], W[:j], d))
        fe, de = rel(w, w0), dot_err(raw, raw0, W, w0)
        errs["K1"] = max(errs["K1"], float((w - w0).abs().max()))
        return fe, de

    def parity_pipe(j, last, d, ny, nx, P=2):
        av, *W = [field(ny, nx, P) for _ in range(j + 2)]
        scal = scalars(j + 2)
        got, want = both(lambda: lz.pipe_iso2d(scal, av, W, d, last))
        fe = rel(got[0], want[0])
        errs["K2"] = max(errs["K2"], float((got[0] - want[0]).abs().max()))
        nsq, gram = (got[1], got[2]) if last else (got[2], got[3])
        nsq0, gram0 = (want[1], want[2]) if last else (want[2], want[3])
        de = max(float((nsq - nsq0).abs().max() / nsq0.abs().max()),
                 dot_err(gram, gram0, W, want[0]))
        if not last:
            fe = max(fe, rel(got[1], want[1]))
            errs["K2"] = max(errs["K2"],
                             float((got[1] - want[1]).abs().max()))
            de = max(de, dot_err(got[4], want[4], W + [want[0]], want[1]))
        return fe, de

    def parity_combine(k, ny, nx, P=2):
        W = [field(ny, nx, P) for _ in range(KRYLOV_M)]
        q = (torch.rand((k, KRYLOV_M, 2), generator=gen, device=dev) - 0.5)
        got, want = both(lambda: lz.combine(q, W))
        errs["K3"] = max([errs["K3"]] + [float((a - b).abs().max())
                                         for a, b in zip(got, want)])
        return max(rel(a, b) for a, b in zip(got, want)), 0.0

    ragged = operators.laplacian_2d((250, 333), dx, dx, device=dev).kernel_desc
    clean = dict(desc, variant="clean")
    cases = [
        ("K1 j=0", lambda: parity_pass1(0, desc, N, N)),
        ("K1 j=3", lambda: parity_pass1(3, desc, N, N)),
        ("K2 j=0", lambda: parity_pipe(0, False, desc, N, N)),
        ("K2 j=4", lambda: parity_pipe(4, False, desc, N, N)),
        (f"K2 j={KRYLOV_M - 2} last",
         lambda: parity_pipe(KRYLOV_M - 2, True, desc, N, N)),
        ("K2 j=3 clean", lambda: parity_pipe(3, False, clean, N, N)),
        ("K2 j=2 real", lambda: parity_pipe(2, False, desc, N, N, P=1)),
        ("K3 k=1", lambda: parity_combine(1, N, N)),
        ("K3 k=2", lambda: parity_combine(2, N, N)),
        ("K1 j=2 250x333", lambda: parity_pass1(2, ragged, 250, 333)),
        ("K2 j=2 250x333", lambda: parity_pipe(2, False, ragged, 250, 333)),
        ("K2 j=2 last 250x333",
         lambda: parity_pipe(2, True, ragged, 250, 333)),
        ("K3 k=1 250x333", lambda: parity_combine(1, 250, 333)),
    ]
    for label, fn in cases:
        gate(label, *fn())

    def timed(fn):
        t_k = times_ms(torch, fn)
        config.kernel_mode = "off"
        try:
            t_p = times_ms(torch, fn)
        finally:
            config.kernel_mode = "auto"
        return t_k + t_p          # (dev, wall) kernel, (dev, wall) plain

    def show(label, t):
        print(f"time {label}: kernel {t[0]:.4f} ms device ({t[1]:.4f} "
              f"wall), plain {t[2]:.4f} ms device ({t[3]:.4f} wall)")

    def stacked_complex(W):
        """The planar columns as one (m, n) complex64 tensor (set-up of the
        one-call yardsticks, outside the timed calls)."""
        return torch.stack([torch.complex(w[0], w[1]).reshape(-1)
                            for w in W])

    # kernel vs plain time at the main path's shapes (1024^2, m=10)
    col2 = 2 * N * N * 4
    u = field()
    W = [field() for _ in range(KRYLOV_M)]
    av = field()
    one = torch.eye(1, 2, device=dev)
    q1 = torch.rand((1, KRYLOV_M, 2), generator=gen, device=dev) - 0.5
    k1 = timed(lambda: lz.pass1_iso2d(one, u, [], desc))
    k2 = [0.0] * 4
    for j in range(KRYLOV_M - 1):
        sc = scalars(j + 2)
        t = timed(lambda: lz.pipe_iso2d(sc, av, W[:j + 1], desc,
                                        j == KRYLOV_M - 2))
        show(f"K2 j={j}", t)
        k2 = [a + b for a, b in zip(k2, t)]
    k3 = timed(lambda: lz.combine(q1, W))
    Wc = stacked_complex(W)
    qc = torch.complex(q1[..., 0], q1[..., 1])               # (1, m)
    k3_lib = times_ms(torch, lambda: torch.matmul(qc, Wc))[0]
    del Wc
    times = {"K1": k1, "K2": tuple(k2), "K3": k3}
    for key, t in times.items():
        show(f"{key} per step", t)
    print(f"time K3 one-call yardstick torch.matmul((1, {KRYLOV_M}) c64, "
          f"({KRYLOV_M}, {N * N}) c64): {k3_lib:.4f} ms device")
    # bytes per step: K1 j=0 reads W_0, writes av_0; K2 at j reads av_j and
    # W_0..W_j, writes W_{j+1} and av_{j+1} (the last only W_{j+1}); K3
    # reads m columns, writes 1
    k2_cols = sum(j + 4 for j in range(KRYLOV_M - 2)) + KRYLOV_M + 1
    bytes2 = {"K1": 2 * col2, "K2": k2_cols * col2,
              "K3": (KRYLOV_M + 1) * col2}
    del u, W, av

    # ---------------------------------------------------------- 4. main path
    x = torch.linspace(-LX, LX, N, dtype=torch.float32)
    X, Y = torch.meshgrid(x, x, indexing="ij")
    env = torch.exp(-(X ** 2 + Y ** 2) / 4)
    u0 = torch.stack([env * torch.cos(0.5 * X), env * torch.sin(0.5 * X)])
    m_field = torch.ones((N, N))
    prob = problems.nlse_problem("cubic", (N, N), LX, DT, m_field=m_field,
                                 krylov_m=KRYLOV_M, dtype=torch.complex64)
    check(prob.meta["planar_state"], "main path did not take the planar path")
    check(prob.meta["device"] == "cuda", "main path is not on the card")
    state0 = prob.init(u0)
    snaps, freq = 5, 50
    steps = (snaps - 1) * freq
    counters2 = {"K1": lz.pass1_iso2d, "K2": lz.pipe_iso2d, "K3": lz.combine}
    for f in counters2.values():
        f.launches = 0
    t0 = time.perf_counter()
    traj = problems.run(prob, state0, snaps, freq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters2.items()}
    want = {"K1": steps, "K2": (KRYLOV_M - 1) * steps, "K3": steps}
    print(f"main: {steps} steps of cubic SS2 at {N}^2 m={KRYLOV_M} in "
          f"{wall:.3f} s; launches {launches}")
    check(launches == want, f"launches {launches} != {want}")
    check(tuple(traj.shape) == (snaps, N, N) and traj.dtype == torch.complex64,
          f"snapshots {tuple(traj.shape)} {traj.dtype}")
    check(bool(torch.isfinite(torch.view_as_real(traj)).all()),
          "non-finite snapshot")
    mass = (traj.abs().double() ** 2).sum(dim=(1, 2))
    drift = float(((mass - mass[0]).abs() / mass[0]).max())
    print(f"main: relative mass drift over {steps} steps {drift:.3e}")
    check(drift < 1e-3, f"mass drift {drift:.3e} >= 1e-3")
    del traj

    # ---------------------------------------------------------- 5. paths
    n_par = 20
    auto = prob.observe(advance(prob.step, state0, n_par))
    config.kernel_mode = "off"
    try:
        plain = prob.observe(advance(prob.step, state0, n_par))
        lap = operators.laplacian_2d((N, N), dx, dx, device=dev)
        rho = nlse_density("cubic", m_field.to(dev))

        def complex_step(z, i):
            return boundaries.neumann_no_velocity_2d(
                nlse.ss2_step(z, lap, rho, DT, m=KRYLOV_M))

        cpath = advance(complex_step, prob.observe(state0), n_par)
    finally:
        config.kernel_mode = "auto"
    e_kp, e_pc = rel(auto, plain), rel(plain, cpath)
    print(f"paths: {n_par} steps kernels vs plain planar rel-L2 {e_kp:.3e}; "
          f"plain planar vs complex ss2_step rel-L2 {e_pc:.3e}")
    check(e_kp <= 1e-5, f"kernel vs plain path rel-L2 {e_kp:.3e} > 1e-5")
    check(e_pc <= 2e-4, f"planar vs complex path rel-L2 {e_pc:.3e} > 2e-4")
    del auto, plain, cpath

    # ---------------------------------------------------------- 6. rate
    rate(torch, {"rate": (prob, state0)}, 200, ["rate"] * 3, 20)
    n_eigh = host_syncs(torch, lambda: torch.linalg.eigh(
        torch.eye(KRYLOV_M, device=dev)))
    print(f"rate: host syncs in one {KRYLOV_M}x{KRYLOV_M} torch.linalg.eigh "
          f"alone: {n_eigh}")
    del prob, state0

    # ---------------------------------------------------------- 7. parity3d
    def ops3d(shape, c=None):
        """The main path's three 3D operator descriptors on `shape`."""
        d3 = 2.0 * LX / (shape[-1] - 1)
        if c is None:
            c = 1.0 + 0.4 * torch.rand(shape, generator=gen, device=dev)
        return {"iso": operators.laplacian_3d(shape, d3,
                                              device=dev).kernel_desc,
                "clean": operators.laplacian_3d(shape, d3, variant="clean",
                                                device=dev).kernel_desc,
                "aniso": operators.anisotropic_laplacian_3d(
                    c, d3, device=dev).kernel_desc}

    def parity_pass1_3d(j, d, R, nx):
        W = [field(R, nx) for _ in range(j + 1)]
        scal = torch.tensor([[0.7, 0.3]], device=dev)
        (w, raw), (w0, raw0) = both(lambda: l3.pass1_3d(scal, W[j], W[:j], d))
        errs["pass1_3d"] = max(errs["pass1_3d"], float((w - w0).abs().max()))
        return rel(w, w0), dot_err(raw, raw0, W, w0)

    def parity_pass2(j, R, nx):
        w, *W = [field(R, nx) for _ in range(j + 2)]
        q = torch.rand((j + 1, 2), generator=gen, device=dev) - 0.5
        (a, n1), (b, n0) = both(lambda: l3.pass2(q, w, W))
        errs["pass2"] = max(errs["pass2"], float((a - b).abs().max()))
        return rel(a, b), float((n1 - n0).abs().max() / n0.abs().max())

    for shape in ((N3, N3, N3), (37, 50, 61)):
        R, nx = shape[0] * shape[1], shape[2]
        tag = "x".join(map(str, shape))
        for mode, d in ops3d(shape).items():
            for j in (0, 4, 8):
                gate(f"pass1_3d {mode} j={j} {tag}",
                     *parity_pass1_3d(j, d, R, nx))
        for j in (0, 4, 8):
            gate(f"pass2 j={j} {tag}", *parity_pass2(j, R, nx))
        up = field(R, nx)
        got, want = both(lambda: b3.neumann_bc_planar_3d(up.clone(), shape))
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        print(f"parity bc3d {tag}: exactly equal {same}")
        check(same, f"bc3d {tag} differs from its plain version")
        del up, got, want

    # 3D times per step of the main path (128^3, m=10, iso reference)
    shape3 = (N3, N3, N3)
    R3 = N3 * N3
    col3 = 2 * R3 * N3 * 4
    d3 = ops3d(shape3)
    W = [field(R3, N3) for _ in range(KRYLOV_M)]
    w = field(R3, N3)
    scal = torch.tensor([[0.7, 0.3]], device=dev)
    Wc = stacked_complex(W)
    wc = torch.complex(w[0], w[1]).reshape(1, -1)
    t3 = {"pass1_3d": [0.0] * 4, "pass1_3d aniso": [0.0] * 4,
          "pass2": [0.0] * 4}
    pass2_lib = 0.0
    for j in range(KRYLOV_M - 1):
        for key, d in (("pass1_3d", d3["iso"]),
                       ("pass1_3d aniso", d3["aniso"])):
            t = timed(lambda: l3.pass1_3d(scal, W[j], W[:j], d))
            show(f"{key} j={j}", t)
            t3[key] = [a + b for a, b in zip(t3[key], t)]
        q = torch.rand((j + 1, 2), generator=gen, device=dev) - 0.5
        t = timed(lambda: l3.pass2(q, w, W[:j + 1]))
        show(f"pass2 j={j}", t)
        t3["pass2"] = [a + b for a, b in zip(t3["pass2"], t)]
        qc = torch.complex(q[:, 0], q[:, 1]).reshape(1, -1)
        lib = times_ms(torch, lambda: torch.addmm(wc, qc, Wc[:j + 1],
                                                  alpha=-1))[0]
        print(f"time pass2 j={j} one-call yardstick torch.addmm (leaves out "
              f"the norm): {lib:.4f} ms device")
        pass2_lib += lib
    t3["combine 128^3"] = timed(lambda: lz.combine(q1, W))
    qc = torch.complex(q1[..., 0], q1[..., 1])
    combine3_lib = times_ms(torch, lambda: torch.matmul(qc, Wc))[0]
    up = field(R3, N3)
    t3["bc3d"] = timed(lambda: b3.neumann_bc_planar_3d(up, shape3))
    for key, t in t3.items():
        show(f"{key} per step", t)
    print(f"time pass2 one-call yardsticks per step: {pass2_lib:.4f} ms; "
          f"combine 128^3 torch.matmul: {combine3_lib:.4f} ms device")
    bc_cells = (2 * N3 * N3 + 2 * (N3 - 2) * N3 + 2 * (N3 - 2) * (N3 - 2))
    # bytes per step: pass1 at j reads W_0..W_j and writes w (aniso also
    # reads three weight planes); pass2 at j reads w and W_0..W_j and writes
    # W_{j+1}; bc3d reads and writes the face cells
    bytes3 = {"pass1_3d": sum(j + 2 for j in range(KRYLOV_M - 1)) * col3,
              "pass1_3d aniso": (sum(j + 2 for j in range(KRYLOV_M - 1))
                                 + 1.5 * (KRYLOV_M - 1)) * col3,
              "pass2": sum(j + 3 for j in range(KRYLOV_M - 1)) * col3,
              "combine 128^3": (KRYLOV_M + 1) * col3,
              "bc3d": bc_cells * 2 * 4 * 2}
    for key, nb in bytes3.items():
        print(f"bound {key} per step: {nb / 1e6:.1f} MB -> "
              f"{bound_ms(nb):.4f} ms at 3.35 TB/s; kernel at "
              f"{bound_ms(nb) / t3[key][0]:.3f} of it")
    del W, w, Wc, wc, up, d3

    # ---------------------------------------------------------- 8. main3d
    def problem3d(n, c=None):
        prob = problems.nlse_problem("cubic", (n, n, n), LX, DT,
                                     m_field=torch.ones((n, n, n)),
                                     c_field=c, krylov_m=KRYLOV_M)
        check(prob.meta["planar_state"] and prob.meta["device"] == "cuda",
              f"3D problem at {n}^3 did not take the planar path on the card")
        x = torch.linspace(-LX, LX, n, dtype=torch.float32, device=dev)
        Z, Y, X = torch.meshgrid(x, x, x, indexing="ij")
        env = torch.exp(-(X ** 2 + Y ** 2 + Z ** 2) / 4)
        u0 = torch.stack([env * torch.cos(0.5 * X), env * torch.sin(0.5 * X)])
        return prob, prob.init(u0)

    counters3 = {"pass1_3d": l3.pass1_3d, "pass2": l3.pass2,
                 "combine": lz.combine, "bc3d": b3.neumann_bc_planar_3d}
    per_step3 = {"pass1_3d": KRYLOV_M - 1, "pass2": KRYLOV_M - 1,
                 "combine": 1, "bc3d": 1}
    c3 = torch.from_numpy((1.0 + 0.4 * np.random.default_rng(0).random(
        shape3)).astype(np.float32))

    def main3d(label, prob, state0, snaps, freq):
        steps = (snaps - 1) * freq
        for f in counters3.values():
            f.launches = 0
        t0 = time.perf_counter()
        traj = problems.run(prob, state0, snaps, freq)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: f.launches for k, f in counters3.items()}
        want = {k: v * steps for k, v in per_step3.items()}
        print(f"{label}: {steps} steps at {N3}^3 m={KRYLOV_M} in {wall:.3f} "
              f"s; launches {got} ({sum(got.values()) / steps:.0f} per step)")
        check(got == want, f"{label}: launches {got} != {want}")
        check(tuple(traj.shape) == (snaps,) + shape3, f"{label}: snapshots "
              f"{tuple(traj.shape)}")
        check(bool(torch.isfinite(torch.view_as_real(traj)).all()),
              f"{label}: non-finite snapshot")
        mass = (traj.abs().double() ** 2).sum(dim=(1, 2, 3))
        drift = float(((mass - mass[0]).abs() / mass[0]).max())
        print(f"{label}: relative mass drift over {steps} steps {drift:.3e}")
        check(drift < 1e-3, f"{label}: mass drift {drift:.3e} >= 1e-3")
        return got

    prob3, s3 = problem3d(N3)
    snaps3, freq3 = 5, 50
    steps3 = (snaps3 - 1) * freq3
    launches3 = main3d("main3d iso", prob3, s3, snaps3, freq3)
    prob3c, s3c = problem3d(N3, c3)
    main3d("main3d c(x)", prob3c, s3c, 3, 50)

    # ---------------------------------------------------------- 9. paths3d
    for label, prob, s0, c in (("iso", prob3, s3, None),
                               ("c(x)", prob3c, s3c, c3)):
        auto = prob.observe(advance(prob.step, s0, n_par))
        config.kernel_mode = "off"
        try:
            plain = prob.observe(advance(prob.step, s0, n_par))
            d3x = 2.0 * LX / (N3 - 1)
            lap = (operators.laplacian_3d(shape3, d3x, device=dev)
                   if c is None else
                   operators.anisotropic_laplacian_3d(c, d3x, device=dev))
            rho = nlse_density("cubic", torch.ones(shape3, device=dev))

            def complex_step(z, i):
                return boundaries.neumann_no_velocity_3d(
                    nlse.ss2_step(z, lap, rho, DT, m=KRYLOV_M))

            cpath = advance(complex_step, prob.observe(s0), n_par)
        finally:
            config.kernel_mode = "auto"
        e_kp, e_pc = rel(auto, plain), rel(plain, cpath)
        print(f"paths3d {label}: {n_par} steps kernels vs plain planar "
              f"rel-L2 {e_kp:.3e}; plain planar vs complex ss2_step rel-L2 "
              f"{e_pc:.3e}")
        check(e_kp <= 1e-5, f"3D {label} kernel vs plain path rel-L2 "
              f"{e_kp:.3e} > 1e-5")
        check(e_pc <= 2e-4, f"3D {label} planar vs complex path rel-L2 "
              f"{e_pc:.3e} > 2e-4")
        del auto, plain, cpath

    # ---------------------------------------------------------- 10. rate3d
    iso, cx = f"rate3d iso {N3}^3", f"rate3d c(x) {N3}^3"
    rate(torch, {iso: (prob3, s3), cx: (prob3c, s3c)}, 100,
         [iso, cx, cx, iso, iso, cx, iso, iso], 20, host_profile=True)
    del prob3, s3, prob3c, s3c
    prob_big, s_big = problem3d(N3_BIG)
    big = f"rate3d iso {N3_BIG}^3"
    rate(torch, {big: (prob_big, s_big)}, 20, [big] * 3, 5)
    del prob_big, s_big

    def entry(kname, source, replaces, launches_, n_steps, err, t, nbytes,
              lib):
        """One kernel of the JSON line: `launches` over the n_steps of its
        main path's run; `ms`, `plain_ms`, `bound_ms` and `library_ms` per
        step of that path."""
        return dict(name=kname, route="cuda", source=source,
                    replaces=replaces, launches=launches_,
                    launches_per_step=launches_ / n_steps, max_abs_err=err,
                    ms=t[0], plain_ms=t[2], bound_ms=bound_ms(nbytes),
                    bound_by="bytes", library_ms=lib)

    kernels = [
        entry("pass1_iso2d", SOURCE, f"{PALLAS}:473", launches["K1"], steps,
              errs["K1"], times["K1"], bytes2["K1"], None),
        entry("pipe_iso2d", SOURCE, f"{PALLAS}:779", launches["K2"], steps,
              errs["K2"], times["K2"], bytes2["K2"], None),
        entry("combine", SOURCE, f"{PALLAS}:1005", launches["K3"], steps,
              errs["K3"], times["K3"], bytes2["K3"], k3_lib),
        entry("pass1_3d", SOURCE3, f"{PALLAS3}:391", launches3["pass1_3d"],
              steps3, errs["pass1_3d"], t3["pass1_3d"], bytes3["pass1_3d"],
              None),
        entry("pass2", SOURCE3, f"{PALLAS}:938", launches3["pass2"], steps3,
              errs["pass2"], t3["pass2"], bytes3["pass2"], pass2_lib),
        entry("bc3d", SOURCE3, f"{PALLAS_BC}:52", launches3["bc3d"], steps3,
              0.0, t3["bc3d"], bytes3["bc3d"], None),
    ]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
