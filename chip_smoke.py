#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the repository root: `python3 chip_smoke.py`. Needs one CUDA card,
nvcc (the kernels are built from nlsolvers_tpu_torch/csrc at first use) and
nvidia-smi. Imports torch and nlsolvers_tpu_torch only, never JAX.

Phases, one line each:
  1. device    the card's name and `nvidia-smi` name, power limit
  2. build     nvcc build of csrc/lanczos2d.cu, in seconds
  3. parity    each kernel against its plain PyTorch version on the same
               seeded CUDA tensors, at 1024^2 complex64 and on a ragged
               250x333 grid: fields rel-L2 <= 1e-5 (same elementwise
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
  6. rate      steps/s: median of 5 chunks of 200 steps, synchronized; the
               device's busy time per step from torch.profiler, and the host
               syncs one step makes.
Then the kernels as one JSON line, and last {"ok": true, "device": ...}.
Any failed phase exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

N, LX, DT, KRYLOV_M = 1024, 10.0, 1e-4, 10
FIELD_TOL, DOT_TOL = 1e-5, 1e-4
SOURCE = "nlsolvers_tpu_torch/csrc/lanczos2d.cu"
PALLAS = "nlsolvers_tpu/ops/pallas/lanczos2d.py"


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


def times_ms(torch, fn, reps=20):
    """(device, wall) ms per call of fn: the summed device time of the
    kernels it launches (torch.profiler), and CUDA events around each call,
    median, which include the host's enqueue time when that is longer."""
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = sum(dev_us(e) for e in prof.key_averages()) / 1e3 / reps
    check(device > 0, "torch.profiler recorded no device time")
    return device, statistics.median(walls)


def main():
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
    from nlsolvers_tpu_torch.ops.cuda import lanczos2d as lz

    check("jax" not in sys.modules, "jax was imported")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls must stay off (torch default)")
    dev = torch.device("cuda", 0)

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
    _build.library("lanczos2d")
    log = _build.build_log("lanczos2d")
    spills = [ln for ln in (log.read_text().splitlines() if log.exists()
                            else [])
              if "spill stores" in ln and " 0 bytes spill stores" not in ln]
    print(f"build: {_build.build_seconds('lanczos2d'):.2f} s (nvcc sm_90a "
          f"and load); kernels that spill registers: {len(spills)}")

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

    dx = 2.0 * LX / (N - 1)
    desc = operators.laplacian_2d((N, N), dx, dx, device=dev).kernel_desc
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0}

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
        fe, de = fn()
        torch.cuda.synchronize()
        print(f"parity {label}: field rel-L2 {fe:.3e}, dot err {de:.3e}")
        check(fe <= FIELD_TOL, f"{label}: field rel-L2 {fe:.3e} > {FIELD_TOL}")
        check(de <= DOT_TOL, f"{label}: dot error {de:.3e} > {DOT_TOL}")

    # kernel vs plain time at the main path's shapes (1024^2, m=10)
    u = field()
    W = [field() for _ in range(KRYLOV_M)]
    av = field()
    one = torch.eye(1, 2, device=dev)
    q1 = torch.rand((1, KRYLOV_M, 2), generator=gen, device=dev) - 0.5

    def timed(fn):
        t_k = times_ms(torch, fn)
        config.kernel_mode = "off"
        try:
            t_p = times_ms(torch, fn)
        finally:
            config.kernel_mode = "auto"
        return t_k + t_p          # (dev, wall) kernel, (dev, wall) plain

    k1 = timed(lambda: lz.pass1_iso2d(one, u, [], desc))
    k2 = [0.0] * 4
    for j in range(KRYLOV_M - 1):
        sc = scalars(j + 2)
        t = timed(lambda: lz.pipe_iso2d(sc, av, W[:j + 1], desc,
                                        j == KRYLOV_M - 2))
        print(f"time K2 j={j}: kernel {t[0]:.4f} ms device "
              f"({t[1]:.4f} wall), plain {t[2]:.4f} ms device "
              f"({t[3]:.4f} wall)")
        k2 = [a + b for a, b in zip(k2, t)]
    k3 = timed(lambda: lz.combine(q1, W))
    times = {"K1": k1, "K2": tuple(k2), "K3": k3}
    for key, t in times.items():
        print(f"time {key} per step: kernel {t[0]:.4f} ms device "
              f"({t[1]:.4f} wall), plain {t[2]:.4f} ms device "
              f"({t[3]:.4f} wall)")
    del u, W, av

    # ---------------------------------------------------------- 4. main path
    x = torch.linspace(-LX, LX, N, dtype=torch.float32)
    X, Y = torch.meshgrid(x, x, indexing="ij")
    env = torch.exp(-(X ** 2 + Y ** 2) / 4)
    u0 = torch.stack([env * torch.cos(0.5 * X), env * torch.sin(0.5 * X)])
    m_field = torch.ones((N, N))
    prob = problems.nlse_problem("cubic", (N, N), LX, DT, m_field=m_field,
                                 krylov_m=KRYLOV_M, dtype=torch.complex64,
                                 device=dev)
    check(prob.meta["planar_state"], "main path did not take the planar path")
    state0 = prob.init(u0)
    snaps, freq = 5, 50
    steps = (snaps - 1) * freq
    lz.pass1_iso2d.launches = lz.pipe_iso2d.launches = lz.combine.launches = 0
    t0 = time.perf_counter()
    traj = problems.run(prob, state0, snaps, freq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": lz.pass1_iso2d.launches, "K2": lz.pipe_iso2d.launches,
                "K3": lz.combine.launches}
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

    # ---------------------------------------------------------- 5. paths
    def advance(step, s, n):
        for i in range(1, n + 1):
            s = step(s, i)
        return s

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

    # ---------------------------------------------------------- 6. rate
    chunk, reps = 200, 5
    s = advance(prob.step, state0, 10)
    torch.cuda.synchronize()
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        s = advance(prob.step, s, chunk)
        torch.cuda.synchronize()
        rates.append(chunk / (time.perf_counter() - t0))
    check(bool(torch.isfinite(s).all()), "non-finite state after timing")
    sps = statistics.median(rates)
    print(f"rate: {sps:.2f} steps/s median of {reps} x {chunk} steps "
          f"(min {min(rates):.2f}, max {max(rates):.2f}); {1e3 / sps:.4f} "
          f"ms/step")

    from torch.profiler import ProfilerActivity, profile
    n_prof = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s = advance(prob.step, s, n_prof)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    busy_ms = sum(dev_us(e) for e in rows) / 1e3 / n_prof
    if busy_ms > 0:
        print(f"rate: device busy {busy_ms:.4f} ms/step of "
              f"{1e3 / sps:.4f} ms/step -> idle share "
              f"{1 - busy_ms * sps / 1e3:.3f}")
        launched = sum(e.count for e in rows if dev_us(e) > 0) / n_prof
        print(f"rate: {launched:.0f} kernel launches per step")
        top = sorted(rows, key=dev_us, reverse=True)[:8]
        for e in top:
            print(f"  {dev_us(e) / 1e3 / n_prof:9.4f} ms/step "
                  f"{e.count // n_prof:4d}x/step {e.key[:70]}")
    else:
        print("rate: device busy time not measured (profiler saw no device "
              "time)")

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            s = prob.step(s, 1)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    n_syncs = sum("synchroniz" in str(w.message) for w in caught)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.linalg.eigh(torch.eye(KRYLOV_M, device=dev))
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    n_eigh = sum("synchroniz" in str(w.message) for w in caught)
    print(f"rate: host syncs in one step: {n_syncs}; in one "
          f"{KRYLOV_M}x{KRYLOV_M} torch.linalg.eigh alone: {n_eigh}")

    kernels = [
        dict(name="pass1_iso2d", route="cuda", source=SOURCE,
             replaces=f"{PALLAS}:473", launches=launches["K1"],
             max_abs_err=errs["K1"], ms=times["K1"][0],
             plain_ms=times["K1"][2]),
        dict(name="pipe_iso2d", route="cuda", source=SOURCE,
             replaces=f"{PALLAS}:779", launches=launches["K2"],
             max_abs_err=errs["K2"], ms=times["K2"][0],
             plain_ms=times["K2"][2]),
        dict(name="combine", route="cuda", source=SOURCE,
             replaces=f"{PALLAS}:1005", launches=launches["K3"],
             max_abs_err=errs["K3"], ms=times["K3"][0],
             plain_ms=times["K3"][2]),
    ]
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
