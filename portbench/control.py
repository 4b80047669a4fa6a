"""The readings that the check's limits are set from, at a cell's size.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--witness]

For each seed: the cell's inputs and one whole batch of the timed path (the
sweep's trajectory function, read back as the window reads it). Then, on
the lanes the check compares, every interval from the program's own
snapshot, as check.py reads it: the program's widest gap to the float64
reference (the lower reading) and the control's, the reference run in the
precision below the configuration's (its `tf32` precision: float32 or
complex64 with the Krylov products on TF32 operands) from the same states
(the upper reading), each also per compared field. Prints one JSON line
per seed.

--witness adds whole trajectories of every lane of the batch: the
program's gap to the float64 reference run from the input, and the gap of
the plain float32 reference (precision "float32"), a second float32
implementation: what float32 rounding alone does to a whole trajectory of
each lane (the widest over the compared fields).
"""

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import bench, check, families
from portbench.traffic import generate


def whole_gaps(fields, state, m, c, lanes, spec, block):
    """{lane: (program's widest gap, plain float32 reference's widest
    gap)} over whole trajectories and the compared fields, both against
    the float64 reference run from the input."""
    ref = check.reference(spec)
    kw = dict(system=spec["system"], Lx=spec["Lx"], dt=spec["dt"],
              krylov_m=spec["krylov_m"], num_snapshots=spec["snapshots"],
              snapshot_freq=spec["freq"])
    dev = m.device
    out = {}
    for i in range(0, len(lanes), block):
        blk = lanes[i:i + block]
        idx = torch.tensor(blk, device=dev)
        first = [x[idx] for x in state]
        worst = torch.zeros((2, len(blk)), dtype=torch.float64, device=dev)
        plain = {}
        ref.trajectory(*first, m[idx], c[idx], precision="float32",
                       emit=lambda s, *f: plain.update(
                           {s: [x.cpu() for x in f]}), **kw)

        def emit(s, *exact, blk=blk, worst=worst, plain=plain):
            prog = ref.from_program(tuple(torch.from_numpy(
                np.ascontiguousarray(fields[name][blk, s])).to(
                    dev, torch.float64) for name in ref.FIELDS))
            for row, got in enumerate((prog, plain[s])):
                for g, e in zip(got, exact):
                    gap = check._norm(g.to(dev, e.dtype) - e) / check._norm(e)
                    gap = torch.where(torch.isfinite(gap), gap,
                                      torch.full_like(gap, 1e300))
                    torch.maximum(worst[row], gap, out=worst[row])

        ref.trajectory(*first, m[idx], c[idx], emit=emit, **kw)
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
        fam = families.family(cl.fields)
        B, S, freq = mix["batch"], spec["snapshots"], spec["freq"]
        for seed in (int(x) for x in args.seeds.split(",")):
            t0 = time.perf_counter()
            state, m, c, _ = generate.make_inputs(mix, cl.fields, seed,
                                                  "cuda")
            out = dg.traj_fn(*state, m, c, S, freq)
            got = families.held(fam, out, type(dg)._host)
            del out
            torch.cuda.empty_cache()
            lanes = check.sample_lanes(seed, B, wl["check_lanes"])[0]
            gaps = check.interval_gaps(got["fields"], m, c, lanes, spec,
                                       wl["check_block"], others=("tf32",))
            names = check.reference(spec).FIELDS
            row = {"seed": seed, "lanes": lanes,
                   "program": max(max(gaps[x][0].values()) for x in lanes),
                   "control": min(max(gaps[x][1].values()) for x in lanes),
                   "program_fields": {n: max(gaps[x][0][n] for x in lanes)
                                      for n in names},
                   "control_fields": {n: min(gaps[x][1][n] for x in lanes)
                                      for n in names},
                   "program_lanes": [max(gaps[x][0].values())
                                     for x in lanes],
                   "control_lanes": [max(gaps[x][1].values())
                                     for x in lanes],
                   "not_finite": int(np.sum(got["bad_at"] < S)),
                   "start_gap": check.start_gap([got], state, spec)}
            if args.witness:
                whole = whole_gaps(got["fields"], state, m, c,
                                   list(range(B)), spec, wl["check_lanes"])
                row["whole_program_lanes"] = [whole[x][0] for x in range(B)]
                row["whole_float32_lanes"] = [whole[x][1] for x in range(B)]
            row["seconds"] = time.perf_counter() - t0
            print(json.dumps(row), flush=True)
            del got
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
