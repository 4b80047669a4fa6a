"""The plain reference against the port's plain CPU path, and the control
(the reference with its Krylov products in TF32) against the cells'
limits, at sizes a test run holds: 32^2 with B=2 and 16^3."""

import tempfile

import pytest
import torch

from portbench import cells, check
from portbench.traffic import generate

SIZES = {2: dict(cell="nlse2d-sweep.task30", nx=32, nt=80, T=0.048,
                 snapshots=5),
         3: dict(cell="nlse2d-sweep.task30", dim=3, nx=16, nt=40, T=0.024,
                 snapshots=5, krylov_m=10, phenomenon="multi_soliton_state")}


def _program(dim, seed):
    """(fields, spec, u0, m, c, snaps, limits): one tiny batch of the port
    on the CPU through the sweep's trajectory function."""
    from nlsolvers_tpu_torch.pipeline.datagen import Datagen, DatagenConfig
    size = dict(SIZES[dim])
    wl = cells.workload(size.pop("cell"))
    cfg = cells.config(wl["config"])
    mix = dict(generate.load_mix(wl["traffic"]), batch=2)
    fields = dict(cells.datagen_fields(cfg), num_runs=2, batch_size=2,
                  device="cpu", **size)
    with tempfile.TemporaryDirectory() as out:
        dg = Datagen(DatagenConfig(output_dir=out, **fields))
        u0, m, c, _ = generate.make_inputs(mix, fields, seed, "cpu")
        S, freq = dg.cfg.snapshots, dg.cfg.snapshot_freq
        snaps, bad_at = dg.traj_fn(u0, m, c, S, freq)
        spec = dict(reference=cfg["reference"], Lx=dg.cfg.Lx, dt=dg.cfg.dt,
                    krylov_m=dg.cfg.krylov_m, snapshots=S, freq=freq)
    assert bool((bad_at == S).all())
    return spec, u0, m, c, snaps.numpy(), wl["limits"]


@pytest.mark.parametrize("dim", (2, 3))
def test_reference_agrees_with_the_port(dim):
    """Whole tiny trajectories of the reference and of the port's CPU path
    agree to float32 rounding, and so does every interval the check
    compares."""
    from portbench.reference import nlse_ss2
    spec, u0, m, c, snaps, limits = _program(dim, 2 ** 31 + 11)
    gaps = []

    def emit(s, u):
        p = torch.from_numpy(snaps[:, s]).double()
        d = torch.complex(p[:, 0], p[:, 1]) - u
        gaps.append(float((check._norm(d) / check._norm(u)).max()))

    nlse_ss2.trajectory(u0, m, c, Lx=spec["Lx"], dt=spec["dt"],
                        krylov_m=spec["krylov_m"],
                        num_snapshots=spec["snapshots"],
                        snapshot_freq=spec["freq"], emit=emit)
    assert gaps[0] == 0 and 0 < max(gaps) < 1e-4
    worst = check.interval_gaps(snaps, m, c, [0, 1], spec, block=4)
    assert 0 < max(g[0] for g in worst.values()) <= limits["rel_l2"]


@pytest.mark.parametrize("dim", (2, 3))
def test_control_fails_the_limit(dim):
    """The reference in the precision below the configuration's (complex64,
    the Krylov products on TF32 operands), run from the same states, reads
    above the cell's limit even at this size; the port reads below it."""
    spec, u0, m, c, snaps, limits = _program(dim, 2 ** 31 + 12)
    gaps = check.interval_gaps(snaps, m, c, [0, 1], spec, block=8,
                               others=("tf32",))
    assert max(g[0] for g in gaps.values()) <= limits["rel_l2"]
    assert min(g[1] for g in gaps.values()) > limits["rel_l2"]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0000001], dtype=torch.float32)
    from portbench.reference.nlse_ss2 import tf32_round
    got = tf32_round(x)
    assert got[0] == 1.0 and got[1] == 1.0          # a tie goes to even
    assert got[2] == 1.0 + 2 ** -10 and got[3] == -3.0
