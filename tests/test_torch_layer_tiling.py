"""Kernel 4's, kernel 8's and kernel 9's launch shapes, decided on the host.

Kernel 4 (one attention layer's forward) stacks R batch rows a block as
kernel 2 does: here its choice is held to the card's limits, as
tests/test_torch_attention_tiling.py holds kernel 2's (under 232,448
bytes of shared memory a block, staging dropped only where it does not
fit, every batch row in exactly one block, R=4 and 128 blocks at B=512).

Kernel 8 (the cross network's forward) gives each block FWD_WARPS warps
and each warp 2 rows where a lane's share of a row is at most 4 chunks
and the blocks still fill the card, else 1: every row is visited once at
every batch size that phase 11 of chip_smoke.py checks, and B=512 at the
DCN's D=368 is one wave of 128 blocks; it takes any number of layers.
Kernel 9 (the cross network's backward) runs as one launch of clusters
of 8 blocks, each warp carrying its rows two at a time: every row is
visited once, a block's shared memory fits, the grid is whole clusters
at most one block an SM, the flagship's rows take one pass and its
partial sums stay tens of KB, and shapes the kernel does not take (over
8 layers, over MAX_CHUNKS chunks a lane) are refused.  The kernels
themselves run only on the card (tests/test_torch_kernels_gpu.py).
"""

import pytest
import torch

from tpurec_torch.ops.attention import (FWD_FILL, SMEM_LIMIT,
                                        attention_layer_fwd,
                                        layer_fwd_config, layer_smem_bytes)
from tpurec_torch.ops.cross_network import (BWD_MAX_WARPS, CLUSTER,
                                            FWD_MAX_WARPS, FWD_WARPS,
                                            MAX_CHUNKS,
                                            BWD_MAX_LAYERS, bwd_config,
                                            bwd_smem_bytes,
                                            cross_network_bwd,
                                            cross_network_fwd, fwd_config,
                                            rows_per_warp)

N_SM = 132                       # the H100's streaming multiprocessors
FLAGSHIP = (23, 64, 2)           # F, A, H of the flagship attention head
TEST = (12, 8, 2)                # the card tests' dropout-decoding shapes
SHAPES = [FLAGSHIP, TEST, (23, 64, 8), (50, 64, 8), (96, 64, 2),
          (106, 64, 2), (39, 32, 4)]
LAYER_BATCHES = list(range(1, 1200, 7)) + [4097]


# -- kernel 4 ----------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("B", [1, 3, 5, 511, 512, 513, 4097])
def test_layer_launch_fits_shared_memory(shape, B):
    R, stage, smem = layer_fwd_config(B, *shape, n_sm=N_SM)
    assert R >= 1
    assert smem == layer_smem_bytes(*shape, R, stage) <= SMEM_LIMIT == 232448
    if not stage:        # staging is dropped only where it does not fit
        assert layer_smem_bytes(*shape, 1, True) > SMEM_LIMIT


@pytest.mark.parametrize("shape", [FLAGSHIP, TEST])
def test_layer_blocks_cover_every_batch_row_once(shape):
    """The kernel's partition at every B of range(1, 1200, 7) and 4097:
    block b takes rows b*R .. b*R + R - 1 that are < B; the grid fills the
    card or takes one row a block; the block fits and stages its weights
    (they fit at these shapes)."""
    for B in LAYER_BATCHES:
        R, stage, smem = layer_fwd_config(B, *shape, n_sm=N_SM)
        blocks = -(-B // R)
        rows = [b * R + r for b in range(blocks) for r in range(R)
                if b * R + r < B]
        assert rows == list(range(B)), B
        assert smem <= SMEM_LIMIT and stage, B
        assert R == 1 or blocks >= FWD_FILL * N_SM, B


def test_layer_flagship_launch():
    """B=512 at F=23: R=4, 128 blocks on 132 SMs, w_in and w_out staged;
    the layout by hand: x 96x68 (the scores 4*2*23 x 28 fit inside it),
    qkv 96x196, w_in 64x200, w_out 64x72."""
    R, stage, smem = layer_fwd_config(512, *FLAGSHIP, n_sm=N_SM)
    assert (R, stage, -(-512 // R)) == (4, True, 128)
    assert smem == 4 * (96 * 68 + 96 * 196 + 64 * 200 + 64 * 72) == 171008
    assert layer_fwd_config(4096, *FLAGSHIP, n_sm=N_SM) == (4, True, smem)
    # more rows a block would leave SMs idle at 512
    assert -(-512 // (R + 1)) < FWD_FILL * N_SM


def test_layer_shape_over_the_budget_is_refused():
    with pytest.raises(ValueError, match="shared memory"):
        layer_fwd_config(4, 200, 64, 8, n_sm=N_SM)
    with pytest.raises(ValueError, match="shared memory"):
        layer_fwd_config(4096, 5, 1024, 2, n_sm=N_SM)


def test_layer_wrapper_refuses_other_devices():
    F, A, H = TEST
    ws = [torch.zeros(s, device="meta")
          for s in ((A, 3 * A), (3 * A,), (A, A), (A,))]
    with pytest.raises(ValueError, match="cuda or cpu"):
        attention_layer_fwd(torch.zeros(2, F, A, device="meta"), *ws, H)


# -- kernel 9 ----------------------------------------------------------------

CROSS_SHAPES = [(368, 3, 4), (200, 3, 1), (13, 3, 1), (24, 2, 4),
                (1024, 3, 4), (512, 4, 4), (256, 8, 1)]


def visits(B, D, L, vec, n_sm=N_SM):
    """Rows in the order the launch's warps take them: block b's warp w
    takes rows (b*W + w)*K + k, then a grid's stride on."""
    W, K, grid, _ = bwd_config(B, D, L, vec, n_sm)
    out = []
    for b in range(grid):
        for w in range(W):
            row0 = (b * W + w) * K
            while row0 < B:
                out += [row0 + k for k in range(K) if row0 + k < B]
                row0 += grid * W * K
    return out


@pytest.mark.parametrize("shape", CROSS_SHAPES)
@pytest.mark.parametrize("B", [1, 2, 3, 7, 8, 9, 63, 64, 65, 511, 512, 513,
                               1023, 1024, 1025, 4097])
def test_cross_bwd_visits_every_row_once(shape, B):
    rows = visits(B, *shape)
    assert sorted(rows) == list(range(B))
    assert len(rows) == len(set(rows))


@pytest.mark.parametrize("shape", CROSS_SHAPES)
@pytest.mark.parametrize("B", [1, 512, 4097])
def test_cross_bwd_launch_fits(shape, B):
    D, L, vec = shape
    W, K, grid, smem = bwd_config(B, D, L, vec, N_SM)
    assert 1 <= W <= BWD_MAX_WARPS and K == rows_per_warp(D, vec)
    assert K == (2 if -(-D // (32 * vec)) <= 4 else 1)
    assert smem == bwd_smem_bytes(D, L, vec, W) <= SMEM_LIMIT
    # whole clusters, at most one block an SM
    assert grid % CLUSTER == 0 and CLUSTER <= grid <= N_SM


def test_cross_bwd_flagship_launch():
    """The DCN step's B=512 at D=368, L=3: 4 warps of 2 rows, 64 blocks (8
    clusters) take every row in one pass; the partial sums are one [2, L,
    D] slice a cluster, 70,656 B; the layout by hand: w and the running
    sums of b, 4 warp slices, 32 dot products a warp, 3 scalars for each
    of 8 layers of a warp's 2 rows."""
    W, K, grid, smem = bwd_config(512, 368, 3, 4, N_SM)
    assert (W, K, grid) == (4, 2, 64)
    assert grid * W * K == 512
    assert grid // CLUSTER * 2 * 3 * 368 * 4 == 70656
    assert smem == 4 * (2 * 3 * 368 + 4 * 2 * 3 * 368 + 4 * 32
                        + 4 * 2 * 3 * 8) == 45440
    # larger batches take more clusters, up to one block an SM
    assert bwd_config(4096, 368, 3, 4, N_SM)[2] == 128


def test_cross_bwd_refuses_what_the_kernel_does_not_take():
    bwd_config(512, 368, BWD_MAX_LAYERS, 4, N_SM)
    with pytest.raises(ValueError, match="layers"):
        bwd_config(512, 368, BWD_MAX_LAYERS + 1, 4, N_SM)
    with pytest.raises(ValueError, match="chunks"):
        bwd_config(512, 32 * MAX_CHUNKS * 4 + 4, 3, 4, N_SM)
    with pytest.raises(ValueError, match="chunks"):
        bwd_config(512, 32 * MAX_CHUNKS + 1, 3, 1, N_SM)
    # the widest rows at the most layers fit with fewer warps
    W, _, _, smem = bwd_config(512, 32 * MAX_CHUNKS * 4, BWD_MAX_LAYERS, 4,
                               N_SM)
    assert W < 4 and smem <= SMEM_LIMIT
    x = torch.zeros(4, 6, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cross_network_bwd(x, torch.zeros(2, 6, device="meta"),
                          torch.zeros(2, 6, device="meta"), x)


# -- kernel 8 ----------------------------------------------------------------

# the batch sizes at which phase 11 of chip_smoke.py checks kernels 8 and 9
PHASE11_BATCHES = [1, 2, 3, 8, 9, 64, 65, 512, 513, 1024, 1025, 4096, 4097]


def fwd_visits(B, D, L, vec, warps=None):
    """Rows in the order kernel 8's warps take them: block b's warp w
    takes rows (b*W + w)*K .. + K - 1 that are < B."""
    K, W, grid = (fwd_config(B, D, L, vec, N_SM) if warps is None
                  else fwd_config(B, D, L, vec, N_SM, warps=warps))
    return [(b * W + w) * K + k for b in range(grid) for w in range(W)
            for k in range(K) if (b * W + w) * K + k < B]


@pytest.mark.parametrize("shape", CROSS_SHAPES)
@pytest.mark.parametrize("B", PHASE11_BATCHES)
def test_cross_fwd_visits_every_row_once(shape, B):
    assert fwd_visits(B, *shape) == list(range(B))
    D, _, vec = shape
    K, W, grid = fwd_config(B, *shape, N_SM)
    assert W == FWD_WARPS <= FWD_MAX_WARPS
    # rows_per_warp rows a warp where the blocks still fill the card
    full = -(-B // (rows_per_warp(D, vec) * W)) >= N_SM
    assert K == (rows_per_warp(D, vec) if full else 1)
    # no block without a row
    assert (grid - 1) * W * K < B


@pytest.mark.parametrize("warps", range(1, FWD_MAX_WARPS + 1))
def test_cross_fwd_visits_every_row_at_each_block_size(warps):
    """The rows-a-block settings phase 15 sweeps, at the DCN's shape."""
    for B in PHASE11_BATCHES:
        assert fwd_visits(B, 368, 3, 4, warps) == list(range(B)), B


def test_cross_fwd_flagship_launch():
    """The DCN's D=368 at 16-byte loads is 3 chunks a lane.  B=512 takes
    1 row a warp, 128 blocks of 4 warps, one wave on 132 SMs (2 rows a
    warp would leave half the SMs idle); B=4096 2 rows a warp, 512
    blocks."""
    assert fwd_config(512, 368, 3, 4, N_SM) == (1, 4, 128)
    assert fwd_config(4096, 368, 3, 4, N_SM) == (2, 4, 512)
    assert rows_per_warp(368, 4) == 2 and rows_per_warp(368, 1) == 1
    # a row of 13 at scalar loads is one chunk a lane
    assert fwd_config(37, 13, 3, 1, N_SM) == (1, 4, 10)
    assert fwd_config(37 * 64, 13, 3, 1, N_SM)[0] == 2


def test_cross_fwd_refuses_what_the_kernel_does_not_take():
    # any number of layers: the forward takes them three at a time
    for L in (1, BWD_MAX_LAYERS, BWD_MAX_LAYERS + 1, 20):
        assert fwd_config(512, 368, L, 4) == (1, 4, 128)
    with pytest.raises(ValueError, match="chunks"):
        fwd_config(512, 32 * MAX_CHUNKS * 4 + 4, 3, 4)
    x = torch.zeros(4, 6, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cross_network_fwd(x, torch.zeros(2, 6, device="meta"),
                          torch.zeros(2, 6, device="meta"))
