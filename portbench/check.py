"""How `correct` is decided: what the timed batches returned, against the
plain reference (portbench/reference/), after the window has closed.

The reference follows the program interval by interval: for every compared
answer (`check_lanes` distinct lanes, each from one of the timed
batches, drawn from the seed by sample_lanes) and every snapshot s >= 1,
it starts from the program's own snapshot s-1 (the state the program held
there, as the reference module's `start` reads it) and runs the `freq`
steps to snapshot s in float64. Whole trajectories are not compared: on
lanes whose solitons collapse, float32 rounding alone grows to gaps of
order 1 over a trajectory, as much in a second, plain float32
implementation (reference precision "float32") as in the program (PERF.md,
section 2), so a whole trajectory's gap cannot tell a sound float32
program from one in a lower precision. The start, which intervals skip, is
checked by itself: snapshot 0 has to be the input, bit for bit.

  rel_l2            the widest relative L2 gap ||f_s - R(x_{s-1})_f|| /
                    ||R(x_{s-1})_f|| over every compared answer, interval
                    and field f (R: the reference's freq steps in float64
                    from the snapshot x_{s-1}; each field relative to its
                    own norm)
  start_gap         the largest |snapshot 0 - input| of any lane of any
                    timed batch, over the fields that snapshot 0 holds bit
                    for bit (limit 0)
  lanes_not_finite  lanes of the timed batches whose guard flagged a
                    non-finite snapshot (bad_at < S); the traffic is drawn
                    from the reference's vetted spaces, on which no run
                    diverges (limit 0)

A reference module (portbench/reference/<name>.py, named by the
configuration's `reference`) declares what the check reads of it: FIELDS,
the program's snapshot fields it compares, in the order its trajectory
emits them; EXACT_START, the fields that snapshot 0 holds bit for bit;
start(snapshot), the state an interval starts from, from the program's
snapshot s-1 ({field: tensor}); from_program(fields), the program's
compared fields as its trajectory emits them; and trajectory(*state, m, c,
system=, Lx=, dt=, krylov_m=, num_snapshots=, snapshot_freq=, emit=,
precision=), which calls emit(s, *fields) at each snapshot. The state's
tensors are the configuration's family's (portbench/families.py): field i
at snapshot 0 is state tensor i.

Intervals run `check_block` at a time, one reference pass for all of them,
so that it fits beside what the program left on the card.
"""

import importlib

import numpy as np
import torch

from portbench import families

__all__ = ["sample_lanes", "reference", "spec", "interval_gaps",
           "start_gap", "judge"]


def sample_lanes(seed, B, k, batches=1):
    """{batch: sorted lanes}: the answers the check compares, drawn from
    the seed. Every batch of the window runs the same inputs, so a lane is
    one trajectory whichever batch returned it: k distinct lanes (every
    lane where k >= B; else the first and the last, which a fault at the
    edge of a launch's lanes would hit, and k - 2 others), each taken from
    one of the window's batches."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 1])
    lanes = list(range(B))
    if k < B:
        lanes = [0, B - 1] + [int(x) for x in rng.choice(
            np.arange(1, B - 1), size=max(k - 2, 0), replace=False)]
    out = {}
    for lane in sorted(lanes):
        out.setdefault(int(rng.integers(batches)), []).append(lane)
    return dict(sorted(out.items()))


def reference(spec):
    """The reference module of a check's `spec`."""
    return importlib.import_module(f"portbench.reference.{spec['reference']}")


def spec(reference, dgc):
    """What the check needs of a configuration: its reference module's
    name and, from its DatagenConfig `dgc`, the family, system, Lx, dt,
    Krylov m, snapshots and snapshot cadence."""
    return dict(reference=reference, family=dgc.family, system=dgc.system,
                Lx=dgc.Lx, dt=dgc.dt, krylov_m=dgc.krylov_m,
                snapshots=dgc.snapshots, freq=dgc.snapshot_freq)


def _norm(x):
    axes = tuple(range(1, x.dim()))
    sq = x.real ** 2 + x.imag ** 2 if x.is_complex() else x * x
    return torch.sqrt(torch.sum(sq, dim=axes))


def interval_gaps(fields, m, c, lanes, spec, block, others=()):
    """{lane: [{field: widest gap over its intervals}, ...]} of the
    snapshot stacks `fields` ({name: (B, S, ...) numpy}): first the
    stacks' own gaps to the float64 reference from their previous
    snapshot, then, for each precision in `others`, the gaps of the
    reference run in that precision from the same state. `spec` is
    spec()'s; m and c are the lanes' fields on the reference's device."""
    ref = reference(spec)
    dev = m.device
    S = next(iter(fields.values())).shape[1]
    items = [(lane, s) for lane in lanes for s in range(1, S)]
    worst = {lane: [dict.fromkeys(ref.FIELDS, 0.0)
                    for _ in range(1 + len(others))] for lane in lanes}
    kw = dict(system=spec["system"], Lx=spec["Lx"], dt=spec["dt"],
              krylov_m=spec["krylov_m"], num_snapshots=2,
              snapshot_freq=spec["freq"])
    for i in range(0, len(items), block):
        chunk = items[i:i + block]
        ln = [lane for lane, _ in chunk]

        def stack(name, back=0, chunk=chunk):
            return torch.from_numpy(np.stack(
                [fields[name][lane, s - back] for lane, s in chunk]))

        start = ref.start({name: stack(name, 1).to(dev) for name in fields})
        idx = torch.tensor(ln, device=dev)

        def interval(prec, start=start, idx=idx):
            snap = {}
            ref.trajectory(*start, m[idx], c[idx], precision=prec,
                           emit=lambda s, *f: snap.update({s: f}), **kw)
            return [f.to(torch.complex128 if f.is_complex()
                         else torch.float64) for f in snap[1]]

        exact = interval("float64")
        nref = [_norm(e) for e in exact]
        for k, prec in enumerate((None,) + tuple(others)):
            got = (ref.from_program(tuple(
                stack(name).to(dev, torch.float64) for name in ref.FIELDS))
                if prec is None else interval(prec))
            for name, g, e, n in zip(ref.FIELDS, got, exact, nref):
                g = _norm(g - e) / n
                g = torch.where(torch.isfinite(g), g,
                                torch.full_like(g, float("inf"))).tolist()
                for lane, v in zip(ln, g):
                    worst[lane][k][name] = max(worst[lane][k][name], v)
    return worst


def start_gap(batches, state, spec):
    """The largest |snapshot 0 - input| of the batches (families.held's
    dicts) over the reference's EXACT_START fields, each against the state
    tensor at its position in the family's fields."""
    fields = families.family(spec).fields
    gap = 0.0
    for name in reference(spec).EXACT_START:
        first = state[fields.index(name)].cpu().numpy()
        gap = max([gap] + [float(np.max(np.abs(
            b["fields"][name][:, 0] - first))) for b in batches])
    return gap


def judge(batches, state, m, c, picks, spec, limits, block):
    """(correct, numbers): numbers {name: (value, limit)} of the timed
    batches (families.held's dicts: host `fields` and `bad_at`) against
    the inputs `state` (the family's state tensors), the intervals of the
    lanes `picks` ({batch: lanes}) compared."""
    S = spec["snapshots"]
    start = start_gap(batches, state, spec)
    not_finite = int(sum(int(np.sum(b["bad_at"] < S)) for b in batches))
    rel = 0.0
    for k, lanes in picks.items():
        gaps = interval_gaps(batches[k]["fields"], m, c, lanes, spec, block)
        rel = max([rel] + [max(g[0].values()) for g in gaps.values()])
    numbers = {"rel_l2": (rel, limits["rel_l2"]),
               "start_gap": (start, limits["start_gap"]),
               "lanes_not_finite": (not_finite, limits["lanes_not_finite"])}
    correct = all(v <= lim for v, lim in numbers.values())
    return correct, numbers
