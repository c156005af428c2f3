"""Kernel 2's launch shape, decided on the host: how many batch rows R a
block stacks, whether its weights are staged in shared memory, and the
shared memory that takes.  The kernel itself runs only on the card
(tests/test_torch_kernels_gpu.py); here the wrapper's choices are held to
the card's limits: under 232,448 bytes of shared memory a block, the grid
filling the card at B=512, every batch row in exactly one block, and a
shape over the budget refused with ValueError."""

import pytest
import torch

from tpurec_torch.ops.attention import (FWD_FILL, SMEM_LIMIT,
                                        field_attention_fwd, fwd_config,
                                        rows_per_block, smem_bytes)

N_SM = 132                       # the H100's streaming multiprocessors
FLAGSHIP = (23, 16, 64, 2)       # F, D, A, H of the flagship attention head
TEST = (12, 4, 8, 2)             # the card tests' dropout-decoding shapes
SHAPES = [FLAGSHIP, TEST, (23, 16, 64, 8), (50, 16, 64, 8), (96, 16, 64, 2),
          (106, 16, 64, 2), (39, 16, 32, 4)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("B", [1, 3, 5, 512, 513, 4097])
def test_launch_fits_shared_memory(shape, B):
    R, stage, smem = fwd_config(B, *shape, n_sm=N_SM)
    assert R >= 1
    assert smem == smem_bytes(*shape, R, stage) <= SMEM_LIMIT == 232448
    if stage:            # staging is dropped only where it does not fit
        return
    assert smem_bytes(*shape, 1, True) > SMEM_LIMIT


def test_flagship_fills_the_card_at_512():
    R, stage, smem = fwd_config(512, *FLAGSHIP, n_sm=N_SM)
    blocks = -(-512 // R)
    assert (R, stage) == (4, True)
    assert blocks == 128 and blocks >= FWD_FILL * N_SM
    assert smem == 171008           # x 96x68, qkv 96x196, w 64x200 + 64x72
    assert fwd_config(4096, *FLAGSHIP, n_sm=N_SM)[:2] == (4, True)
    # more rows a block would leave SMs idle at 512
    assert -(-512 // (R + 1)) < FWD_FILL * N_SM


@pytest.mark.parametrize("shape", [FLAGSHIP, TEST])
def test_batch_sizes_fill_the_card_or_take_one_row(shape):
    for B in range(1, 1200, 7):
        R = rows_per_block(B, *shape, n_sm=N_SM)
        assert R == 1 or -(-B // R) >= FWD_FILL * N_SM


@pytest.mark.parametrize("shape", [FLAGSHIP, TEST])
@pytest.mark.parametrize("B", [1, 3, 4, 5, 511, 512, 513, 4095, 4096,
                               4097])
def test_blocks_cover_every_batch_row_once(shape, B):
    """The kernel's partition: block b takes rows b*R .. b*R + R - 1 that
    are < B (n_real = min(R, B - b*R) of them); the last block is partly
    past B exactly when R does not divide B."""
    R = rows_per_block(B, *shape, n_sm=N_SM)
    blocks = -(-B // R)
    rows = [b * R + r for b in range(blocks) for r in range(R)
            if b * R + r < B]
    assert rows == list(range(B))
    n_real = [min(R, B - b * R) for b in range(blocks)]
    assert min(n_real) >= 1 and sum(n_real) == B
    assert (n_real[-1] < R) == (B % R != 0)


def test_shape_over_the_budget_is_refused():
    with pytest.raises(ValueError, match="shared memory"):
        fwd_config(4, 200, 16, 64, 8, n_sm=N_SM)
    with pytest.raises(ValueError, match="shared memory"):
        fwd_config(4096, 5, 16, 1024, 2, n_sm=N_SM)


def test_wrapper_refuses_other_devices():
    F, D, A, H = TEST
    flat = [torch.zeros(s, device="meta") if s else None
            for s in ((D, A), (A,), None, None, (A, 3 * A), (3 * A,),
                      (A, A), (A,))]
    with pytest.raises(ValueError, match="cuda or cpu"):
        field_attention_fwd(torch.zeros(2, F, D, device="meta"), flat, 1, H)
