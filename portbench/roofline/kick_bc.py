"""kick_bc (csrc/kick.cu kick_bc_kernel): both half kicks of an SS2 step,
the closing one with the no-flux ghost copy. Each reads u (8 bytes a
point) and m (4) and writes the kicked u (8)."""


def per_step(s):
    # |u|^2 (3), times m and theta (2), sin and cos (2), complex product (6)
    return 2, 2 * 20 * s.points, 2 * 13 * s.points
