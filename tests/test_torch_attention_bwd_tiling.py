"""Kernels 3 and 5's launch shape, decided on the host: how many batch rows
R a backward block stacks, whether w_in and w_out are staged in shared
memory, the shared memory that takes, and the persistent grid.  The
kernels themselves run only on the card (tests/test_torch_kernels_gpu.py);
here the wrapper's choices are held to the card's limits: under 232,448
bytes of shared memory a block, staging dropped only where it does not
fit, every batch row in exactly one group of R rows, at most one block
(and one slice of weight-gradient partials) per SM with the partials of
the flagship shapes inside the 50 MB L2, and a shape over the budget
refused with ValueError."""

import math

import pytest
import torch

from tpurec_torch.ops.attention import (BWD_ROWS, SMEM_LIMIT,
                                        attention_layer_bwd, bwd_config,
                                        bwd_grid, bwd_smem_bytes,
                                        field_attention_bwd,
                                        layer_bwd_config)

N_SM = 132                       # the H100's streaming multiprocessors
L2_BYTES = 50 * 1024 * 1024      # the H100's L2
FLAGSHIP = (23, 16, 64, 2)       # F, D, A, H of the flagship attention head
TEST = (12, 4, 8, 2)             # the card tests' dropout-decoding shapes
AMAZON = (8, 16, 64, 2)          # the flagship head on Amazon's 8 fields
SHAPES = [FLAGSHIP, TEST, AMAZON, (23, 16, 64, 8), (39, 16, 32, 4), (23, 16, 128, 2),
          (49, 16, 64, 2), (60, 16, 64, 1)]
BATCHES = [1, 3, 512, 513, 4097]


def n_weight_grads(D, A, L=3, res=True):
    """Floats of kernel 3's weight gradients (the source's GradOffsets)."""
    return D * A + A + (D * A + A if res else 0) + L * (4 * A * A + 4 * A)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("kernel", ["stack", "layer"])
def test_launch_fits_shared_memory(shape, B, kernel):
    F, D, A, H = shape
    if kernel == "layer":
        D = 0
        R, stage, smem, grid = layer_bwd_config(B, F, A, H, n_sm=N_SM)
    else:
        R, stage, smem, grid = bwd_config(B, F, D, A, H, n_sm=N_SM)
    assert 1 <= R <= BWD_ROWS
    assert smem == bwd_smem_bytes(F, D, A, H, R, stage) <= SMEM_LIMIT == 232448
    # more rows a block, or staging, only where they do not fit
    if R < BWD_ROWS:
        assert bwd_smem_bytes(F, D, A, H, R + 1, stage) > SMEM_LIMIT
    if not stage:
        assert bwd_smem_bytes(F, D, A, H, 1, True) > SMEM_LIMIT
    assert grid == bwd_grid(B, R, N_SM)


def test_flagship_launches():
    """R=2 at F=23 (46 stacked rows in 48), weights staged, 128 blocks at
    B=512 each taking two groups; the layout's bytes counted by hand."""
    R, stage, smem, grid = bwd_config(512, *FLAGSHIP, n_sm=N_SM)
    assert (R, stage, grid) == (2, True, 128)
    # w_in 64x200, w_out 64x72; qkv, dqkv 48x196; xin, o, dO, dx 48x68;
    # s, ds 2*2*23 x 28; emb, demb part 48x20
    want = 4 * (64 * 200 + 64 * 72 + 2 * 48 * 196 + 4 * 48 * 68
                + 2 * 92 * 28 + 2 * 48 * 20)
    assert smem == want == 225408
    assert layer_bwd_config(512, 23, 64, 2, n_sm=N_SM) == (
        2, True, want - 4 * 2 * 48 * 20, 128)


@pytest.mark.parametrize("B", [1, 512, 4096, 4097])
def test_amazon_launches(B):
    """At F=8 a block stacks BWD_ROWS = 2 batch rows, 16 field rows: one
    m16 tile, no padding; the weights staged; the persistent grid at most
    one block per SM, each walking its groups, every batch row once."""
    R, stage, smem, grid = bwd_config(B, *AMAZON, n_sm=N_SM)
    F, D, A, H = AMAZON
    assert (R, stage) == (BWD_ROWS, True) and R * F == 16
    assert smem == bwd_smem_bytes(F, D, A, H, R, True) == 117760
    assert grid == bwd_grid(B, R, N_SM) == {1: 1, 512: 128, 4096: 128,
                                            4097: 129}[B] <= N_SM
    groups = -(-B // R)
    rows = sorted(q * R + r for b in range(grid)
                  for q in range(b, groups, grid) for r in range(R)
                  if q * R + r < B)
    assert rows == list(range(B))


@pytest.mark.parametrize("R", [1, 2, 3])
@pytest.mark.parametrize("B", [1, 2, 3, 4, 511, 512, 513, 4097])
def test_groups_cover_every_batch_row_once(R, B):
    """The kernels' partition: block b takes groups b, b + grid, ...; group
    q holds rows q*R .. q*R + R - 1 that are < B.  Every block gets a
    group, no two blocks' group counts differ by more than one, and the
    grid is at most one block per SM."""
    grid = bwd_grid(B, R, N_SM)
    groups = -(-B // R)
    assert 1 <= grid <= min(N_SM, groups)
    rows = []
    per_block = []
    for b in range(grid):
        mine = list(range(b, groups, grid))
        per_block.append(len(mine))
        for q in mine:
            rows += [q * R + r for r in range(R) if q * R + r < B]
    assert sorted(rows) == list(range(B))
    assert min(per_block) >= 1 and max(per_block) - min(per_block) <= 1
    # no tail wave: every block walks the same number of groups, within one
    assert max(per_block) == -(-groups // N_SM)


def test_no_batch_gives_no_grid():
    assert bwd_grid(0, 2, N_SM) == 0


@pytest.mark.parametrize("B", [512, 4096, 65536])
def test_partials_fit_in_l2(B):
    """One slice of partials per block, at most one block per SM: kernel
    3's partial sums at the flagship shapes stay inside the L2."""
    F, D, A, H = FLAGSHIP
    _, _, _, grid = bwd_config(B, F, D, A, H, n_sm=N_SM)
    assert grid <= N_SM
    assert grid * n_weight_grads(D, A) * 4 <= L2_BYTES
    _, _, _, grid = layer_bwd_config(B, F, A, H, n_sm=N_SM)
    assert grid * (4 * A * A + 4 * A) * 4 <= L2_BYTES


def test_shape_over_the_budget_is_refused():
    with pytest.raises(ValueError, match="shared memory"):
        bwd_config(4, 100, 16, 64, 2, n_sm=N_SM)
    with pytest.raises(ValueError, match="shared memory"):
        layer_bwd_config(4096, 50, 64, 8, n_sm=N_SM)
    with pytest.raises(ValueError, match="shared memory"):
        bwd_config(512, 5, 16, 1024, 2, n_sm=N_SM)


def test_wrappers_refuse_other_devices():
    F, D, A, H = TEST
    dev = "meta"
    flat = [torch.zeros(s, device=dev) if s else None
            for s in ((D, A), (A,), None, None, (A, 3 * A), (3 * A,),
                      (A, A), (A,))]
    emb = torch.zeros(2, F, D, device=dev)
    dy = torch.zeros(2, F, A, device=dev)
    with pytest.raises(ValueError, match="cuda or cpu"):
        field_attention_bwd(emb, dy, torch.zeros(1, 2, F, A, device=dev),
                            dy, flat, 1, H)
    with pytest.raises(ValueError, match="cuda or cpu"):
        attention_layer_bwd(dy, dy, *flat[4:8], H)


def test_grid_is_balanced_at_every_size():
    for B in range(1, 3000, 37):
        for R in (1, 2):
            grid = bwd_grid(B, R, N_SM)
            groups = math.ceil(B / R)
            assert grid * math.ceil(groups / grid) >= groups
            assert (grid - 1) * math.ceil(groups / grid) < groups
