"""pass1_shard3d's bricks (ops/cuda/lanczos3d.shard3d_tiles) on the CPU.

The kernel (csrc/lanczos3d.cu pass1_shard3d_kernel) runs only on the card;
its tile map is plain index arithmetic, mirrored here with numpy from the
kernel's source: brick blockIdx.x = (z brick, y tile, x tile) with x tiles
fastest, lane blockIdx.y, thread t at row t / (nxt / 4) of the tile and
column group f = t % (nxt / 4) owning columns 4f..4f+3 (the 16-byte form)
or f + e nxt / 4 (the scalar form), over the brick's planes. For the card
tests' blocks and both batch sizes: every point of the block is owned by
exactly one thread of one brick; the threads are a multiple of 32 and at
most 256, and every thread of a whole tile owns four points; the ring fits
in the H100's 227 KB of shared memory at P = 2 with the face weights; the
map of a lane does not depend on the batch; the partial-sum rows are the
bricks, and the scratch the wrapper allocates holds one row of 2 (j + 1)
sums per brick of each lane.
"""

import numpy as np
import pytest

from nlsolvers_tpu_torch.ops.cuda import lanczos3d as t3

H100_SMEM = 232448                  # bytes of shared memory a block can use
STATIC_ROOM = 8192                  # the kernel's static arrays' room


def _owners(nz, ny, nx, t, vec, B):
    """(B, nz, ny, nx) partial-sum row of the thread owning each point (-1:
    none), the points each thread of each brick owns, and the bricks."""
    nxt, tyt, pz = t["nxt"], t["tyt"], t["pz"]
    ntx, nty, nzb = -(-nx // nxt), -(-ny // tyt), -(-nz // pz)
    nblk = ntx * nty * nzb
    tpr = nxt // 4
    owner = np.full((B, nz, ny, nx), -1, np.int64)
    hits = np.zeros((B, nz, ny, nx), np.int64)
    per_thread = np.zeros((B, nblk, tpr * tyt), np.int64)
    th = np.arange(tpr * tyt)
    ty, f = th // tpr, th % tpr
    e = np.arange(4)
    cols = (4 * f[:, None] + e[None, :]) if vec else (f[:, None]
                                                      + tpr * e[None, :])
    for b in range(B):
        for bx in range(nblk):
            zc, txy = divmod(bx, ntx * nty)
            y0, x0 = (txy // ntx) * tyt, (txy % ntx) * nxt
            z0, z1 = zc * pz, min(zc * pz + pz, nz)
            y = np.broadcast_to((y0 + ty)[:, None], cols.shape)
            ok = (y < ny) & (cols < min(nxt, nx - x0))
            per_thread[b, bx] = ok.sum(axis=1) * (z1 - z0)
            yy, xx = y[ok], x0 + cols[ok]
            for z in range(z0, z1):
                np.add.at(hits[b, z], (yy, xx), 1)
                owner[b, z, yy, xx] = b * nblk + bx
    return owner, hits, per_thread, nblk


_CASES = [(nz, ny, nx, vec) for nx in (2, 50, 64, 256)
          for nz, ny in ((2, 2), (9, 19))
          for vec in ((False, True) if nx % 4 == 0 else (False,))]


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("nz,ny,nx,vec", _CASES)
def test_shard3d_tiles_cover_the_block_once(nz, ny, nx, vec, B):
    t = t3.shard3d_tiles(nz, ny, nx, 2, True, vec)
    nxt, tyt, pz = t["nxt"], t["tyt"], t["pz"]
    tpr = nxt // 4
    assert nxt & (nxt - 1) == 0 and 4 <= nxt <= 128
    assert t["threads"] == tpr * tyt
    assert t["threads"] % 32 == 0 and t["threads"] <= 256
    assert 1 <= pz <= nz
    # the ring at P = 2 with the three face weights, and the iso form
    assert t["smem"] <= t3.SHARD3D_SMEM_MAX
    assert t["smem"] + STATIC_ROOM <= H100_SMEM
    assert t3.shard3d_tiles(nz, ny, nx, 2, False, vec)["smem"] < t["smem"]

    owner, hits, per_thread, nblk = _owners(nz, ny, nx, t, vec, B)
    assert (hits == 1).all()                      # each point once
    assert nblk == t["blocks"]
    # the partial-sum rows are the bricks of each lane, one each
    assert sorted(set(owner.ravel().tolist())) == list(range(B * nblk))
    for j in (0, 9, 18):
        assert t3.shard3d_scratch(nz, ny, nx, t, B, j) == B * nblk * 2 * (
            j + 1)
    # the map of a lane does not depend on the batch
    one = _owners(nz, ny, nx, t3.shard3d_tiles(nz, ny, nx, 2, True, vec),
                  vec, 1)[0][0]
    for b in range(B):
        assert (owner[b] - b * nblk == one).all()
    # every thread of a whole tile (not at the block's ragged end) owns
    # four points of each of its brick's planes
    ntx, nty = -(-nx // nxt), -(-ny // tyt)
    for bx in range(nblk):
        zc, txy = divmod(bx, ntx * nty)
        y0, x0 = (txy // ntx) * tyt, (txy % ntx) * nxt
        if y0 + tyt <= ny and x0 + nxt <= nx:
            planes = min(pz, nz - zc * pz)
            assert (per_thread[:, bx] == 4 * planes).all()
