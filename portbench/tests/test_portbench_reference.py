"""The plain references against the port's plain CPU path, and the control
(the reference with its Krylov products in TF32) against the cells'
limits, at sizes a test run holds: the 2D NLSE at 32^2 with B=2 and 16^3;
the 2D real-wave Gautschi step (sine-Gordon, Klein-Gordon) at 32^2 with
B=2, its cell added as files to a copy of the harness."""

import tempfile

import pytest
import torch

from portbench import cells, check, families
from portbench.traffic import generate

from .conftest import add_tiny

SIZES = {2: dict(cell="nlse2d-sweep.task30", nx=32, nt=80, T=0.048,
                 snapshots=5),
         3: dict(cell="nlse2d-sweep.task30", dim=3, nx=16, nt=40, T=0.024,
                 snapshots=5, krylov_m=10, phenomenon="multi_soliton_state"),
         "sg2d": dict(tiny="tinysg2d", nx=32, nt=80, T=0.048, snapshots=5),
         "kg2d": dict(tiny="tinysg2d", system="klein_gordon", nx=32, nt=80,
                      T=0.048, snapshots=5)}
# the widest gap of a whole tiny trajectory: the two-step real-wave scheme
# grows float32 rounding with the step count (64 steps here: a second,
# plain float32 implementation, precision "float32", reads 3.5e-4-8.9e-4)
WHOLE = {2: 1e-4, 3: 1e-4, "sg2d": 2e-3, "kg2d": 2e-3}


def _program(size, seed, root):
    """(spec, state, m, c, fields, limits): one tiny batch of the port on
    the CPU through the sweep's trajectory function; a real-wave size's
    cell is added to the harness copy at `root` first."""
    from nlsolvers_tpu_torch.pipeline.datagen import Datagen, DatagenConfig
    size = dict(SIZES[size])
    if "tiny" in size:
        cell = add_tiny(root, size.pop("tiny"))
    else:
        cell, root = size.pop("cell"), cells.HERE
    wl = cells.workload(cell, root)
    cfg = cells.config(wl["config"], root)
    mix = dict(generate.load_mix(wl["traffic"], root / "traffic"), batch=2)
    fields = dict(cells.datagen_fields(cfg), num_runs=2, batch_size=2,
                  device="cpu", **size)
    fam = families.family(fields)
    with tempfile.TemporaryDirectory() as out:
        dg = Datagen(DatagenConfig(output_dir=out, **fields))
        state, m, c, _ = generate.make_inputs(mix, fields, seed, "cpu",
                                              root / "traffic")
        S = dg.cfg.snapshots
        got = families.held(fam, dg.traj_fn(*state, m, c, S,
                                            dg.cfg.snapshot_freq),
                            lambda x: x.numpy())
        spec = check.spec(cfg["reference"], dg.cfg)
    assert (got["bad_at"] == S).all()
    return spec, state, m, c, got["fields"], wl["limits"]


@pytest.mark.parametrize("size", tuple(SIZES))
def test_reference_agrees_with_the_port(tiny_root, size):
    """Whole tiny trajectories of the reference and of the port's CPU path
    agree to float32 rounding, and so does every interval the check
    compares."""
    spec, state, m, c, fields, limits = _program(size, 2 ** 31 + 11,
                                                 tiny_root)
    ref = check.reference(spec)
    gaps = []

    def emit(s, *exact):
        got = ref.from_program(tuple(torch.from_numpy(fields[name][:, s])
                                     .double() for name in ref.FIELDS))
        gaps.append(max(float((check._norm(g - e) / check._norm(e)).max())
                        for g, e in zip(got, exact)))

    ref.trajectory(*state, m, c, system=spec["system"], Lx=spec["Lx"],
                   dt=spec["dt"], krylov_m=spec["krylov_m"],
                   num_snapshots=spec["snapshots"],
                   snapshot_freq=spec["freq"], emit=emit)
    assert gaps[0] == 0 and 0 < max(gaps) < WHOLE[size]
    worst = check.interval_gaps(fields, m, c, [0, 1], spec, block=4)
    assert 0 < max(max(g[0].values()) for g in worst.values()) \
        <= limits["rel_l2"]


@pytest.mark.parametrize("size", tuple(SIZES))
def test_control_fails_the_limit(tiny_root, size):
    """The reference in the precision below the configuration's (complex64
    or float32, the Krylov products on TF32 operands), run from the same
    states, reads above the cell's limit even at this size; the port reads
    below it."""
    spec, state, m, c, fields, limits = _program(size, 2 ** 31 + 12,
                                                 tiny_root)
    gaps = check.interval_gaps(fields, m, c, [0, 1], spec, block=8,
                               others=("tf32",))
    assert max(max(g[0].values()) for g in gaps.values()) <= limits["rel_l2"]
    assert min(max(g[1].values()) for g in gaps.values()) > limits["rel_l2"]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0000001], dtype=torch.float32)
    from portbench.reference.nlse_ss2 import tf32_round
    got = tf32_round(x)
    assert got[0] == 1.0 and got[1] == 1.0          # a tie goes to even
    assert got[2] == 1.0 + 2 ** -10 and got[3] == -3.0
