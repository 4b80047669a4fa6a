"""K3 (csrc/lanczos2d.cu combine_kernel): one per matrix function, 2D and
3D; it reads the m columns and writes y = sum_i q_i W_i."""


def per_step(s):
    m = s.krylov_m
    return 1, (m + 1) * s.col, 8 * m * s.points
