"""pass1_3d (csrc/lanczos3d.cu pass1_3d_kernel, K6/K7): launch j = 0..m-2
of the 3D two-pass loop reads W_j, W_0..W_{j-1} and the face weights and
writes w = s_j A W_j - bs W_{j-1} (j + 2 columns), with the j+1 dots."""


def per_step(s):
    if s.dim != 3:
        return None
    m = s.krylov_m
    cols = sum(j + 2 for j in range(m - 1))
    flops = sum(24 + 4 + 8 * (j + 1) for j in range(m - 1))
    return m - 1, cols * s.col + (m - 1) * s.wbytes, flops * s.points
