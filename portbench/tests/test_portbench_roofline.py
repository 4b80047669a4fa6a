"""Byte counts from the shapes against PERF.md's kernel table (batched
forms of B=8: 2D at 256^2, m=20; 3D at 128^3, m=10)."""

import pytest

from portbench import roofline
from portbench.roofline import Shape

TABLE = [  # family, shape, MB per batched step (PERF.md section 6)
    ("pipe_2d", Shape(8, 2, 256, 20, 2), 1107.3),     # K2', batched
    ("pipe_2d", Shape(8, 2, 256, 20, 0), 1031.8),     # K2, batched
    ("pass1_2d", Shape(8, 2, 256, 20, 2), 12.6),      # K1', batched
    ("combine", Shape(8, 2, 256, 20, 2), 88.1),       # K3, batched
    ("pass1_3d", Shape(8, 3, 128, 10, 3), 9059.7),    # K6 c(x), batched
    ("pass1_3d", Shape(8, 3, 128, 10, 0), 7247.8),    # K6 iso, batched
    ("pass2", Shape(8, 3, 128, 10, 3), 8589.9),       # K4 P=2, batched
    ("kick_bc", Shape(8, 3, 128, 10, 3), 671.1),      # kick_bc 3D, both
    ("kick_bc", Shape(8, 2, 256, 20, 2), 21.0),       # kick_bc batched
]


@pytest.mark.parametrize("family,shape,mb", TABLE,
                         ids=[f"{t[0]}-{t[1].dim}d-{t[2]}" for t in TABLE])
def test_bytes_match_the_kernel_table(family, shape, mb):
    _, nbytes, flops = roofline.per_step(family, shape)
    assert round(nbytes / 1e6, 1) == mb
    assert flops / roofline.F32_FLOPS_PER_S < nbytes / roofline.HBM_BYTES_PER_S


def test_families_map_kernel_names():
    names = roofline.families()
    assert roofline.family_of(
        "void pipe_2d_kernel<2, 32, 4, Aniso2d>(float const*, float*)",
        names) == "pipe_2d"
    assert roofline.family_of(
        "void (anonymous namespace)::pass2_kernel<(int)2, 8>(float const*)",
        names) == "pass2"
    assert roofline.family_of("void pass1_shard3d_kernel<8, 4>(int)",
                              names) is None
    assert roofline.family_of("Memcpy DtoH (Device -> Pageable)",
                              names) is None


@pytest.mark.parametrize("dim", (2, 3))
def test_step_floor_is_below_its_kernels(dim):
    """The step's algorithm moves fewer bytes than the kernels that
    implement it today, so a kernel path can never read above the step."""
    s = Shape(30, dim, 200 if dim == 2 else 128, 20 if dim == 2 else 10, dim)
    fams = (("pass1_2d", "pipe_2d") if dim == 2
            else ("pass1_3d", "pass2")) + ("combine", "kick_bc")
    kernels = sum(roofline.per_step(f, s)[1] for f in fams)
    assert roofline.per_step("step_ss2", s)[1] < kernels


@pytest.mark.parametrize("dim,launches,sums", ((2, 20, 780), (3, 19, 100)))
def test_reduction_stage_is_counted(dim, launches, sums):
    """The reductions' second stage is a family of its own: its time counts
    in the kernels' share, its least bytes are the reduced sums alone
    (2D m=20: pass1's 3 and the pipe's; 3D m=10: pass2's norms and
    pass1_3d's projections)."""
    names = roofline.families()
    for kern in ("reduce_partials", "reduce_partials_om"):
        assert roofline.family_of(
            f"void (anonymous namespace)::{kern}(float const*, int, float*)",
            names) == "reduce_partials"
    s = Shape(30, dim, 64, 20 if dim == 2 else 10, dim)
    assert roofline.per_step("reduce_partials", s) == (launches,
                                                        4 * 30 * sums, 0)
