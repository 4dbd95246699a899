"""The Python side of the backward kernel K2b (``warp_narrow_backward``):
its launch plan against a plain walk of the pixels.  The kernel runs only
on the card (``chip_smoke.py`` phase 3b holds it to its plain version
there); the plan it launches with is made here, in Python."""
import numpy as np
import pytest
import torch

from eamm_tpu_torch.ops import warp_cuda

torch.set_num_threads(1)


def _resident(smem):
    """An H100's resident blocks of 256 threads: 132 SMs, at most 8 blocks
    an SM, as many as the shared memory holds."""
    return 132 * min(8, warp_cuda.SMEM_LIMIT // max(smem, 1))


NEEDS = [(False, True), (True, True), (True, False)]


@pytest.mark.parametrize("Bi, group, out_hw, src_hw", [
    (24, 11, (64, 64), (64, 64)),   # the fine-tune step's shape
    (3, 11, (13, 17), (29, 45)),    # ragged: sources start mid-run
    (5, 1, (64, 64), (29, 45)),     # one grid a source
    (4, 3, (13, 17), (64, 64)),
], ids=["24x11-64", "3x11-ragged", "5x1-29x45", "4x3-13x17"])
def test_k2b_plan_covers_every_pixel_once(Bi, group, out_hw, src_hw):
    """Every pixel of every grid is taken exactly once, by a block of its
    own source, for both dtypes and the three gradient choices."""
    B, (Ho, Wo), (H, W) = Bi * group, out_hw, src_hw
    n_px = group * Ho * Wo
    for dtype in (torch.float32, torch.bfloat16):
        for need_image, need_grid in NEEDS:
            plan = warp_cuda.narrow_backward_plan(
                B, Ho, Wo, group, H, W, 3, dtype, need_image, need_grid,
                _resident)
            assert plan.tile == plan.threads * warp_cuda.NARROW_BACKWARD_PIXELS
            assert (plan.tiles - 1) * plan.tile < n_px <= plan.tiles * plan.tile
            taken = warp_cuda.narrow_backward_walk(plan, Bi, n_px)
            np.testing.assert_array_equal(taken, np.ones(Bi * n_px))
            # with the image gradient a source's blocks are one cluster
            assert plan.blocks * Bi <= max(plan.resident, Bi)
            if need_image:
                assert 1 <= plan.blocks <= warp_cuda.NARROW_BACKWARD_CLUSTER


def test_k2b_plan_balances_persistent_blocks():
    """Grid gradient alone at the fine-tune step's shape: as many blocks as
    the card holds, each walking the same number of tiles."""
    plan = warp_cuda.narrow_backward_plan(264, 64, 64, 11, 64, 64, 3,
                                          torch.float32, False, True,
                                          _resident)
    assert plan.smem_bytes == 64 * 64 * 3 * 4 + 16
    assert plan.resident == 132 * 4
    assert plan.threads == warp_cuda.NARROW_BACKWARD_THREADS[False] == 256
    assert plan.tiles == 44 and plan.blocks == 22    # two tiles a block
    assert plan.blocks * 24 <= plan.resident
    # with the image gradient, at most a cluster of 8 blocks a source,
    # however many the card holds: 22 tiles of 512 threads in 3 rounds
    for resident in (132 * 2, 4000):
        image = warp_cuda.narrow_backward_plan(
            264, 64, 64, 11, 64, 64, 3, torch.float32, True, False,
            lambda smem: resident)
        assert (image.threads, image.blocks) == (512, 8)
    assert warp_cuda.NARROW_BACKWARD_CLUSTER == 8
    # a source with fewer tiles than the card holds gets a block a tile
    small = warp_cuda.narrow_backward_plan(2, 13, 17, 1, 29, 45, 3,
                                           torch.float32, False, True,
                                           _resident)
    assert small.blocks == 1


def test_k2b_shared_memory_and_its_limit():
    smem = warp_cuda.narrow_backward_smem
    f32, bf16 = torch.float32, torch.bfloat16
    assert smem(64, 64, 3, f32, False, True) == 49152 + 16
    assert smem(64, 64, 3, f32, True, False) == 49152
    assert smem(64, 64, 3, f32, True, True) == 2 * 49152 + 16
    assert smem(64, 64, 3, bf16, True, True) == 49152 + 24576 + 16
    # ragged: the float32 sums padded to 16 bytes before the staged source
    assert smem(29, 45, 3, bf16, True, True) == 15664 + 7840 + 16
    assert smem(120, 120, 4, f32, True, False) <= warp_cuda.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        smem(120, 120, 4, f32, True, True)
    with pytest.raises(ValueError, match="shared memory"):
        warp_cuda.narrow_backward_plan(2, 8, 8, 1, 128, 128, 4, f32, False,
                                       True, _resident)
    with pytest.raises(ValueError, match="need 1 to 8"):
        warp_cuda.narrow_backward_plan(2, 8, 8, 1, 8, 8, 9, f32, False,
                                       True, _resident)


def test_k2b_reads_dense_motions_gradient_in_place():
    """Dense motion concatenates the deformed copies channel-first beside
    their heatmaps, so their gradient reaches K2b a plane a channel, four
    planes an image.  K2b reads that layout, and NHWC contiguous, in
    place (image, pixel and channel strides); a layout whose rows of
    pixels are not evenly strided is made contiguous first."""
    B, K1, h, w = 2, 11, 64, 64
    hg = torch.zeros(B, K1, 4, h, w)    # heatmap, then the three channels
    planar = hg[:, :, 1:].permute(0, 1, 3, 4, 2).reshape(B * K1, h, w, 3)
    assert not planar.is_contiguous()
    assert warp_cuda.narrow_out_layout(planar) == (4 * h * w, 1, h * w)
    assert warp_cuda.narrow_out_layout(planar.contiguous()) == (
        h * w * 3, 3, 1)
    ragged = torch.zeros(6, 4, 13, 17)[:, 1:].permute(0, 2, 3, 1)
    assert warp_cuda.narrow_out_layout(ragged) == (4 * 13 * 17, 1, 13 * 17)
    assert warp_cuda.narrow_out_layout(planar[1:]) == (4 * h * w, 1, h * w)
    # every other column: rows of pixels evenly strided, read in place
    assert warp_cuda.narrow_out_layout(
        torch.zeros(6, 16, 32, 3)[:, :, ::2]) == (16 * 32 * 3, 6, 1)
    # a crop of each row: rows not evenly strided, made contiguous
    assert warp_cuda.narrow_out_layout(
        torch.zeros(6, 16, 32, 3)[:, :, :16]) is None
