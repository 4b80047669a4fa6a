"""reduce_partials / reduce_partials_om (csrc/lz_common.cuh): the second
stage of every reduction of the Lanczos loop, each block's partial sums of
the kernel before it summed in a fixed order. The partial sums are the
implementation's scratch, not data of the algorithm (the kernels that
write them are not charged for it either), so the least bytes are the
reduced sums alone, written once: time spent here counts against the
kernels' share and earns it nothing.

2D (the pipelined loop): pass1_tile's 3 sums, then pipe launch j (nw =
j + 1 columns) the norm and the Gram row (2 nw), and but in the last launch
the next projections (2 (nw + 1)). 3D (the two-pass loop): pass2's start
norm, then per j pass1_3d's 2 (j + 1) projections and pass2's norm."""


def per_step(s):
    m = s.krylov_m
    if s.dim == 2:
        sums = 3 + sum(1 + 2 * (j + 1) + 2 * (j + 2) for j in range(m - 2))
        sums += 1 + 2 * (m - 1)
        launches = m
    else:
        sums = 1 + sum(2 * (j + 1) + 1 for j in range(m - 1))
        launches = 2 * m - 1
    return launches, 4 * s.B * sums, 0
