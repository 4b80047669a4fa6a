"""K1 / K1' (csrc/lanczos2d.cu pass1_tile_kernel): the pipelined 2D loop's
one pass1 per matrix function, at j = 0. It reads W_0 and the face weights
and writes A W_0, with <W_0, A W_0> and ||W_0||^2 reduced on the way."""


def per_step(s):
    if s.dim != 2:
        return None
    flops = s.points * (16 + 8 + 4)      # stencil, one dot, the norm
    return 1, 2 * s.col + s.wbytes, flops
