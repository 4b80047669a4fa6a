"""How `correct` is decided: what the timed batches returned, against the
plain reference (portbench/reference/), after the window has closed.

The reference follows the program interval by interval: for every compared
answer (`check_lanes` distinct lanes, each from one of the timed
batches, drawn from the seed by sample_lanes) and every snapshot s >= 1,
it starts from the program's own snapshot s-1 (the state the program held
there, exactly) and runs the `freq` steps to snapshot s in float64. Whole
trajectories are not compared: on lanes whose solitons collapse, float32
rounding alone grows to gaps of order 1 over a trajectory, as much in a
second, plain float32 implementation (reference precision "float32") as
in the program (PERF.md, section 2), so a whole trajectory's gap cannot
tell a sound float32 program from one in a lower precision. The start,
which intervals skip, is checked by itself: snapshot 0 has to be the
input, bit for bit.

  rel_l2            the widest relative L2 gap ||u_s - R(u_{s-1})|| /
                    ||R(u_{s-1})|| over every compared answer and interval
                    (R: the reference's freq steps in float64)
  start_gap         the largest |snapshot 0 - u0| of any lane of any timed
                    batch (limit 0)
  lanes_not_finite  lanes of the timed batches whose guard flagged a
                    non-finite snapshot (bad_at < S); the traffic is drawn
                    from the reference's vetted spaces, on which no run
                    diverges (limit 0)

Intervals run `check_block` at a time, one reference pass for all of them,
so that it fits beside what the program left on the card.
"""

import importlib

import numpy as np
import torch

__all__ = ["sample_lanes", "interval_gaps", "judge"]


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


def _norm(x):
    axes = tuple(range(1, x.dim()))
    return torch.sqrt(torch.sum(x.real ** 2 + x.imag ** 2, dim=axes))


def interval_gaps(snaps, m, c, lanes, spec, block, others=()):
    """{lane: [widest gap over its intervals, ...]} of a (B, S, 2, *shape)
    numpy stack: first the stack's own gap to the float64 reference from
    the stack's previous snapshot, then, for each precision in `others`,
    the gap of the reference run in that precision from the same state.
    `spec` holds the configuration's reference module, Lx, dt, krylov_m
    and freq; m and c are the lanes' fields on the reference's device."""
    ref = importlib.import_module(f"portbench.reference.{spec['reference']}")
    dev = m.device
    S = snaps.shape[1]
    items = [(lane, s) for lane in lanes for s in range(1, S)]
    worst = {lane: [0.0] * (1 + len(others)) for lane in lanes}
    kw = dict(Lx=spec["Lx"], dt=spec["dt"], krylov_m=spec["krylov_m"],
              num_snapshots=2, snapshot_freq=spec["freq"])
    for i in range(0, len(items), block):
        chunk = items[i:i + block]
        ln = [lane for lane, _ in chunk]
        start = torch.from_numpy(np.stack(
            [snaps[lane, s - 1] for lane, s in chunk])).to(dev)
        want = torch.from_numpy(np.stack(
            [snaps[lane, s] for lane, s in chunk])).to(dev, torch.float64)
        idx = torch.tensor(ln, device=dev)

        def interval(prec):
            snap = {}
            ref.trajectory(start, m[idx], c[idx], precision=prec,
                           emit=lambda s, u: snap.update({s: u}), **kw)
            return snap[1].to(torch.complex128)

        exact = interval("float64")
        nref = _norm(exact)
        gaps = [_norm(torch.complex(want[:, 0], want[:, 1]) - exact)]
        gaps += [_norm(interval(p) - exact) for p in others]
        for k, g in enumerate(gaps):
            g = g / nref
            g = torch.where(torch.isfinite(g), g,
                            torch.full_like(g, float("inf"))).tolist()
            for lane, v in zip(ln, g):
                worst[lane][k] = max(worst[lane][k], v)
    return worst


def judge(batches, u0, m, c, picks, spec, limits, block):
    """(correct, numbers): numbers {name: (value, limit)} of the timed
    batches (dicts with their host `snaps` and `bad_at`), the intervals of
    the lanes `picks` ({batch: lanes}) compared."""
    S = spec["snapshots"]
    first = u0.cpu().numpy()
    start = max(float(np.max(np.abs(b["snaps"][:, 0] - first)))
                for b in batches)
    not_finite = int(sum(int(np.sum(b["bad_at"] < S)) for b in batches))
    rel = 0.0
    for k, lanes in picks.items():
        gaps = interval_gaps(batches[k]["snaps"], m, c, lanes, spec, block)
        rel = max([rel] + [g[0] for g in gaps.values()])
    numbers = {"rel_l2": (rel, limits["rel_l2"]),
               "start_gap": (start, limits["start_gap"]),
               "lanes_not_finite": (not_finite, limits["lanes_not_finite"])}
    correct = all(v <= lim for v, lim in numbers.values())
    return correct, numbers
