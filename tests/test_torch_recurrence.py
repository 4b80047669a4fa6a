"""The 2D pipelined Lanczos loop's scalar recurrence on the device
(lanczos2d._lanczos_rec) against the same loop's eager torch ops
(lanczos2d._lanczos_eager).

The recurrence kernel (csrc/lanczos2d.cu recur_kernel) has no CPU mode. On
the CPU the K1 / K2 wrappers' plain path runs its plain version, recur_ref,
which mirrors the kernel's arithmetic op by op, on the same state; so these
tests drive recur_ref through the device loop and ask for the eager loop's
bits: every scal a K2 call reads, and s, alphas, betas, beta0 and the
columns. On the card (skipped without one) the kernel itself gives them.

Imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_recurrence.py
"""

import pytest
import torch

from nlsolvers_tpu_torch import config
from nlsolvers_tpu_torch.ops import operators as tops
from nlsolvers_tpu_torch.ops.cuda import lanczos2d as tl

torch.set_num_threads(1)

NY, NX = 14, 19


def _desc(kind, B, gen, device="cpu", variant="reference", sign=1.0):
    """An iso or aniso ("c(x)" per lane) 2D descriptor for B lanes (None:
    one unbatched field)."""
    if kind == "iso":
        d = tops.laplacian_2d((NY, NX), 0.1, 0.1, variant=variant,
                              device=device).kernel_desc
    else:
        cs = [1.0 + 0.4 * torch.rand((NY, NX), generator=gen,
                                     dtype=torch.float64)
              for _ in range(B or 1)]
        d = tops.batched_aniso_laplacian_2d(cs, 0.1, 0.1, device=device)
        if B is None:
            d = dict(d, wx=d["wx"][0].contiguous(),
                     wy=d["wy"][0].contiguous())
    return dict(d, sign=sign)


def _field(P, B, gen, device="cpu"):
    lead = () if B is None else (B,)
    return torch.randn(lead + (P, NY, NX), generator=gen).to(device)


def _bits(a, b):
    """Same shape, dtype and bits (-0.0 is not 0.0 here)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).view(torch.int32),
                            b.reshape(-1).view(torch.int32)))


def _recorded(monkeypatch, loop, u, m, desc):
    """loop(u, m, desc) and a clone of the scal each K2 call read."""
    scals = []
    kernels = tl._pipe_kernels

    def spied(d):
        pass1, pipe = kernels(d)

        def spy(scal, *args, **kw):
            scals.append(scal.clone())
            return pipe(scal, *args, **kw)
        return pass1, spy

    with monkeypatch.context() as mp:
        mp.setattr(tl, "_pipe_kernels", spied)
        out = loop(u, m, desc)
    return out, scals


def _assert_same_run(got, want):
    W, s, alphas, betas, beta0 = got
    for g, w in zip((W, s, alphas, betas), want[:4]):
        assert len(g) == len(w)
        assert all(_bits(a, b) for a, b in zip(g, w))
    assert _bits(beta0, want[4])


def _check(monkeypatch, u, m, desc):
    dev, scal_dev = _recorded(monkeypatch, tl._lanczos_rec, u, m, desc)
    eager, scal_eager = _recorded(monkeypatch, tl._lanczos_eager, u, m,
                                  desc)
    assert len(scal_dev) == len(scal_eager) == m - 1
    assert all(_bits(a, b) for a, b in zip(scal_dev, scal_eager))
    _assert_same_run(dev, eager)
    return dev


@pytest.mark.parametrize("m", [2, 3, 20])
@pytest.mark.parametrize("B", [None, 3])
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("kind", ["iso", "aniso"])
def test_recurrence_matches_eager_loop(monkeypatch, kind, P, B, m):
    """recur_ref through the loop gives the eager loop's scal for every K2
    call and its s, alphas, betas, beta0 and columns, bit for bit; one
    field (B None) and a batch of 3."""
    gen = torch.Generator().manual_seed(100 * m + 10 * P + (B or 1))
    desc = _desc(kind, B, gen, sign=-1.0 if P == 1 else 1.0)
    _check(monkeypatch, _field(P, B, gen), m, desc)


def test_recurrence_zero_lane(monkeypatch):
    """A zero start lane: safe_inv's 0 (beta0 = 0, every s = 0), the other
    lanes as the eager loop's."""
    gen = torch.Generator().manual_seed(7)
    u = _field(2, 3, gen)
    u[1] = 0.0
    s = _check(monkeypatch, u, 6, _desc("aniso", 3, gen))[1]
    assert all(float(x[1]) == 0.0 for x in s)
    assert all(float(x[0]) > 0.0 for x in s)


@pytest.mark.parametrize("B", [None, 2])
def test_recurrence_breakdown(monkeypatch, B):
    """An exact breakdown at the first iteration: a constant field is in the
    clean Laplacian's null space, so W_1 = 0, beta_0 = 0 and s_1 = 0; the
    eager loop's bits on every lane."""
    gen = torch.Generator().manual_seed(8)
    u = _field(2, B, gen)
    u[..., :, :] = 0.25
    if B is not None:
        u[1] = _field(2, None, gen)
    desc = _desc("iso", B, gen, variant="clean")
    _, s, _, betas, _ = _check(monkeypatch, u, 5, desc)
    lane0 = (lambda x: x) if B is None else (lambda x: x[0])
    assert float(lane0(betas[0])) == 0.0 and float(lane0(s[1])) == 0.0


def test_cpu_and_off_take_the_eager_loop(monkeypatch):
    """On the CPU, and under kernel_mode "off", _lanczos_pipe runs the eager
    loop: the device loop is not called, no recurrence kernel is counted,
    and a float64 field stays float64."""
    gen = torch.Generator().manual_seed(9)
    desc = _desc("aniso", 2, gen)
    u = _field(2, 2, gen)

    def refuse(*args):
        raise AssertionError("the device recurrence ran")

    monkeypatch.setattr(tl, "_lanczos_rec", refuse)
    before = tl.recur_kernel.launches
    _assert_same_run(tl._lanczos_pipe(u, 4, desc),
                     tl._lanczos_eager(u, 4, desc))
    monkeypatch.setattr(config, "kernel_mode", "off")
    _, s, alphas, betas, beta0 = tl._lanczos_pipe(u.double(), 4, desc)
    assert all(x.dtype == torch.float64 for x in s + alphas + betas)
    assert beta0.dtype == torch.float64
    assert tl.recur_kernel.launches == before


def test_recurrence_state_checked():
    """A wrapper refuses a recurrence state that does not fit its call: K1
    without the norm or past j = 0, K2 whose `last` is not the run's last
    iteration, a state of the wrong size."""
    gen = torch.Generator().manual_seed(10)
    desc = _desc("iso", None, gen)
    u = _field(2, None, gen)
    m = 4
    state = torch.empty(tl._recur_scal_at(1, m, m - 1))
    one = torch.eye(1, 2)
    with pytest.raises(ValueError):
        tl.pass1_iso2d(one, u, [], desc, rec=(state, m))
    with pytest.raises(ValueError):
        tl.pass1_iso2d(one, u, [u], desc, norm=True, rec=(state, m))
    with pytest.raises(ValueError):
        tl.pass1_iso2d(one, u, [], desc, norm=True, rec=(state[1:], m))
    tl.pass1_iso2d(one, u, [], desc, norm=True, rec=(state, m))
    scal = torch.zeros((2, 2))
    with pytest.raises(ValueError):
        tl.pipe_iso2d(scal, u, [u], desc, True, rec=(state, m))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the recurrence kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("kind,P,B,m", [("aniso", 2, 3, 20),
                                        ("aniso", 2, None, 20),
                                        ("iso", 1, None, 10),
                                        ("iso", 2, 3, 2)])
def test_recurrence_kernel_on_card(monkeypatch, cuda, kind, P, B, m):
    """The recurrence kernel launched inside K1 / K2 gives the eager loop's
    bits (every scal, s, alphas, betas, beta0, the columns), m launches a
    run, and _lanczos_pipe takes it on the card."""
    gen = torch.Generator().manual_seed(11)
    desc = _desc(kind, B, gen, device=cuda, sign=-1.0 if P == 1 else 1.0)
    u = _field(P, B, gen, device=cuda)
    before = tl.recur_kernel.launches
    _check(monkeypatch, u, m, desc)
    assert tl.recur_kernel.launches == before + m
    tl._lanczos_pipe(u, m, desc)
    torch.cuda.synchronize()
    assert tl.recur_kernel.launches == before + 2 * m
