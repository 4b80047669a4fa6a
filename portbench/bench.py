"""One run of one cell: set-up, the timed window, the traced call, the check
and the result line.

The window drives the sweep's own trajectory function,
nlsolvers_tpu_torch.pipeline.datagen.Datagen(DatagenConfig(...)).traj_fn,
on one batch made on the device from the seed, and reads each batch back as
the sweep does (Datagen._host). It starts batches while less than
`seconds` has elapsed and closes when the last started batch's snapshots
are on the host, so every timed batch is whole. Set-up runs from the
harness's first line to the first timed dispatch: imports, the CUDA
context, building or loading the kernels (nlsolvers_tpu_torch/_build/),
the inputs, and a warm-up call of one snapshot interval.

With `trace`, the same window is followed by one traced call of the same
trajectory function on the same batch (3 snapshots at the cell's cadence)
and one more under torch.cuda's sync debug mode. The program's state is
freed before the reference runs (check.py), after the peak memory is read.
"""

import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench import cells, check, roofline
from portbench.trace import count_syncs, short_name, traced
from portbench.traffic import generate

__all__ = ["Record", "Cell", "build", "run_cell", "result_line"]

TRACED_SNAPSHOTS = 3


@dataclass
class Record:
    """What one run measured; the metric readers read it."""
    cell: str
    shape: roofline.Shape
    snapshots: int
    freq: int
    setup_s: float = 0.0
    window_s: float = 0.0
    batches: list = field(default_factory=list)   # per batch: seconds
    memory_peak_bytes: int = 0
    trace: object = None         # trace.Trace of the traced call, or None
    traced_steps: int = 0        # steps of the traced and sync-counted calls
    syncs: int = None

    @property
    def steps_per_traj(self):
        return (self.snapshots - 1) * self.freq

    @property
    def step_s(self):
        """Seconds per batched step in the window, the readback left out."""
        steps = self.steps_per_traj * len(self.batches)
        return sum(b["evolve_s"] for b in self.batches) / steps


def power_limit():
    """The card's power limit as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


@dataclass
class Cell:
    """A cell's files and the program built for it: the sweep's Datagen
    (its traj_fn is the timed path), the DatagenConfig fields as run, and
    `spec`, what the check's reference needs of the configuration."""
    workload: dict
    mix: dict
    fields: dict
    datagen: object
    spec: dict


def build(cell, out_dir, device="cuda", root=cells.HERE):
    """The Cell `cell`, its Datagen writing under `out_dir`."""
    from nlsolvers_tpu_torch.pipeline.datagen import Datagen, DatagenConfig

    wl = cells.workload(cell, root)
    cfg_file = cells.config(wl["config"], root)
    mix = generate.load_mix(wl["traffic"], Path(root) / "traffic")
    B = mix["batch"]
    fields = dict(cells.datagen_fields(cfg_file), num_runs=B, batch_size=B,
                  device=device)
    dg = Datagen(DatagenConfig(output_dir=out_dir, **fields))
    dgc = dg.cfg
    spec = dict(reference=cfg_file["reference"], Lx=dgc.Lx, dt=dgc.dt,
                krylov_m=dgc.krylov_m, snapshots=dgc.snapshots,
                freq=dgc.snapshot_freq)
    return Cell(wl, mix, fields, dg, spec)


def run_cell(cell, seed, seconds, trace, t_start, device="cuda",
             root=cells.HERE, log=print):
    """Run `cell` once; returns (record, correct, numbers, attempted,
    failed)."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out_dir = tempfile.mkdtemp(prefix="portbench-datagen-")
    try:
        cl = build(cell, out_dir, device, root)
        wl, mix, fields, dg, spec = (cl.workload, cl.mix, cl.fields,
                                     cl.datagen, cl.spec)
        dgc = dg.cfg
        B = mix["batch"]
        traj, host = dg.traj_fn, type(dg)._host
        S, freq = spec["snapshots"], spec["freq"]
        rec = Record(cell=cell, snapshots=S, freq=freq,
                     shape=roofline.Shape(
                         B=B, dim=dgc.dim, nx=dgc.nx, krylov_m=dgc.krylov_m,
                         weight_planes=dgc.dim
                         if dgc.anisotropy_type != "constant" else 0))
        u0, m, c, _ = generate.make_inputs(mix, fields, seed, device)

        out = traj(u0, m, c, 2, freq)                     # warm-up
        host(out[0]), host(out[1])
        del out
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec.setup_s = t0 - t_start
        held = []
        while not held or time.perf_counter() - t0 < seconds:
            t_a = time.perf_counter()
            out = traj(u0, m, c, S, freq)
            sync()
            t_b = time.perf_counter()
            snaps, bad_at = host(out[0]), host(out[1])
            t_c = time.perf_counter()
            del out
            held.append(dict(snaps=snaps, bad_at=bad_at))
            rec.batches.append(dict(evolve_s=t_b - t_a, readback_s=t_c - t_b))
            log(f"{cell}: batch {len(held)}: evolve {t_b - t_a:.3f} s, "
                f"readback {t_c - t_b:.3f} s")
        rec.window_s = time.perf_counter() - t0
        if cuda:
            rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
        log(f"{cell}: {len(held)} batch(es) of {B} x {rec.steps_per_traj} "
            f"steps in {rec.window_s:.3f} s, set-up {rec.setup_s:.3f} s")

        if trace and cuda:
            def call():
                traj(u0, m, c, TRACED_SNAPSHOTS, freq)
            rec.traced_steps = (TRACED_SNAPSHOTS - 1) * freq
            rec.trace = traced(torch, call)
            rec.syncs = count_syncs(torch, call)

        writer = getattr(dg, "_npy_writer", None)
        if writer is not None:
            writer.close()
        del cl, dg, traj
        if cuda:
            torch.cuda.empty_cache()

        picks = check.sample_lanes(seed, B, wl["check_lanes"], len(held))
        t_c0 = time.perf_counter()
        correct, numbers = check.judge(held, u0, m, c, picks, spec,
                                       wl["limits"], wl["check_block"])
        log(f"{cell}: check of lanes {picks} (batch: lanes) took "
            f"{time.perf_counter() - t_c0:.3f} s")
        attempted = B * len(held)
        failed = numbers["lanes_not_finite"][0]
        return rec, correct, numbers, attempted, failed
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _number(x):
    """A reading as JSON takes it: non-finite values as strings."""
    x = float(x)
    return x if x == x and abs(x) != float("inf") else str(x)


def result_line(rec, entries, correct, numbers, attempted, failed, device,
                root=cells.HERE):
    """The result object: the metrics of `entries` that their readers find,
    the device, the breakdown when traced, and the compared numbers last."""
    metrics = {}
    for e in entries:
        value = cells.reader(e["name"], root).read(rec)
        if value is not None:
            metrics[e["name"]] = {"value": float(value), "unit": e["unit"]}
    dev = dict(device)
    dev["memory_peak_bytes"] = int(rec.memory_peak_bytes)
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    tr = rec.trace
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        ops = {}
        for name, _, s, e in tr.device:
            key = short_name(name)
            ops[key] = ops.get(key, 0.0) + (e - s)
        gaps = tr.gaps_by_host_op()
        out["breakdown"] = {
            "device_ops": [[k, v] for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[k, v] for k, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:10]]}
    out["check"] = {k: {"value": _number(v), "limit": _number(lim)}
                    for k, (v, lim) in numbers.items()}
    return out
