"""pass2 (csrc/lanczos3d.cu pass2_kernel, K4): the 3D two-pass loop's start
norm (reads W_0) and, for j = 0..m-2, the Gram-Schmidt update: reads w and
W_0..W_j and writes W_{j+1} with its norm (j + 3 columns)."""


def per_step(s):
    if s.dim != 3:
        return None
    m = s.krylov_m
    cols = 1 + sum(j + 3 for j in range(m - 1))
    flops = 4 + sum(8 * (j + 1) + 4 for j in range(m - 1))
    return m, cols * s.col, flops * s.points
