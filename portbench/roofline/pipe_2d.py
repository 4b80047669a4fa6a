"""K2 / K2' (csrc/lanczos2d.cu pipe_2d_kernel): launches j = 0..m-2 of the
pipelined 2D loop. Launch j < m-2 reads W_0..W_j, A W_j and the face
weights and writes W_{j+1} and A W_{j+1} (j + 4 columns); the last one
reads W_0..W_{m-2} and A W_{m-2} and writes W_{m-1} (m + 1 columns)."""


def per_step(s):
    if s.dim != 2:
        return None
    m = s.krylov_m
    cols = sum(j + 4 for j in range(m - 2)) + m + 1
    # per point and launch j: the rebuild over j+1 columns (8 flops each),
    # its norm (4), its Gram row over j+1 columns (8 each), and, but in the
    # last launch, the stencil (16) and j+2 dots against it (8 each)
    flops = sum(8 * (j + 1) + 4 + 8 * (j + 1) + 16 + 8 * (j + 2)
                for j in range(m - 2)) + 16 * (m - 1) + 4
    return m - 1, cols * s.col + (m - 2) * s.wbytes, flops * s.points
