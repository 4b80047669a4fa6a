"""The readings that the check's limits are set from, at a cell's size.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--witness]

For each seed: the cell's inputs and one whole batch of the timed path (the
sweep's trajectory function, read back as the window reads it). Then, on
the lanes the check compares, every interval from the program's own
snapshot, as check.py reads it: the program's widest gap to the float64
reference (the lower reading) and the control's, the reference run in the
precision below the configuration's (complex64 with the Krylov products on
TF32 operands, reference/nlse_ss2.py) from the same states (the upper
reading). Prints one JSON line per seed.

--witness adds whole trajectories of every lane of the batch: the
program's gap to the float64 reference run from the input, and the gap of
the plain float32 reference (reference/nlse_ss2.py, precision "float32"),
a second float32 implementation: what float32 rounding alone does to a
whole trajectory of each lane.
"""

import argparse
import importlib
import json
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import bench, check
from portbench.traffic import generate


def whole_gaps(snaps, u0, m, c, lanes, spec, block):
    """{lane: (program's widest gap, plain float32 reference's widest
    gap)} over whole trajectories, both against the float64 reference run
    from the input."""
    ref = importlib.import_module(f"portbench.reference.{spec['reference']}")
    kw = dict(Lx=spec["Lx"], dt=spec["dt"], krylov_m=spec["krylov_m"],
              num_snapshots=spec["snapshots"], snapshot_freq=spec["freq"])
    out = {}
    for i in range(0, len(lanes), block):
        blk = lanes[i:i + block]
        idx = torch.tensor(blk, device=u0.device)
        worst = torch.zeros((2, len(blk)), dtype=torch.float64,
                            device=u0.device)
        plain = {}
        ref.trajectory(u0[idx], m[idx], c[idx], precision="float32",
                       emit=lambda s, u: plain.update({s: u.cpu()}), **kw)

        def emit(s, u, blk=blk, worst=worst, plain=plain):
            nref = check._norm(u)
            p = torch.from_numpy(np.ascontiguousarray(snaps[blk, s])).to(
                u.device, torch.float64)
            for row, other in enumerate((torch.complex(p[:, 0], p[:, 1]),
                                         plain[s].to(u.device))):
                g = check._norm(other.to(u.dtype) - u) / nref
                g = torch.where(torch.isfinite(g), g,
                                torch.full_like(g, 1e300))
                torch.maximum(worst[row], g, out=worst[row])

        ref.trajectory(u0[idx], m[idx], c[idx], emit=emit, **kw)
        out.update({lane: tuple(worst[:, j].tolist())
                    for j, lane in enumerate(blk)})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--witness", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out_dir = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        cl = bench.build(args.workload, out_dir)
        wl, mix, spec, dg = cl.workload, cl.mix, cl.spec, cl.datagen
        B, S, freq = mix["batch"], spec["snapshots"], spec["freq"]
        for seed in (int(x) for x in args.seeds.split(",")):
            t0 = time.perf_counter()
            u0, m, c, _ = generate.make_inputs(mix, cl.fields, seed, "cuda")
            out = dg.traj_fn(u0, m, c, S, freq)
            snaps, bad_at = type(dg)._host(out[0]), type(dg)._host(out[1])
            del out
            torch.cuda.empty_cache()
            lanes = check.sample_lanes(seed, B, wl["check_lanes"])[0]
            gaps = check.interval_gaps(snaps, m, c, lanes, spec,
                                       wl["check_block"], others=("tf32",))
            row = {"seed": seed, "lanes": lanes,
                   "program": max(g[0] for g in gaps.values()),
                   "control": min(g[1] for g in gaps.values()),
                   "program_lanes": [gaps[lane][0] for lane in lanes],
                   "control_lanes": [gaps[lane][1] for lane in lanes],
                   "not_finite": int(np.sum(bad_at < S)),
                   "start_gap": float(np.max(np.abs(
                       snaps[:, 0] - u0.cpu().numpy())))}
            if args.witness:
                whole = whole_gaps(snaps, u0, m, c, list(range(B)), spec,
                                   wl["check_lanes"])
                row["whole_program_lanes"] = [whole[x][0] for x in range(B)]
                row["whole_float32_lanes"] = [whole[x][1] for x in range(B)]
            row["seconds"] = time.perf_counter() - t0
            print(json.dumps(row), flush=True)
            del snaps
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
