"""The Python side of the backward kernels K1b and K3b: the launch plan and
row split of ``kp_expectation_backward`` and the bins of
``warp_wide_backward``'s gather, against plain recomputations.  The
kernels run only on the card (``chip_smoke.py`` phase 3b holds them to
their plain versions there); what they take from Python is tested here."""
import numpy as np
import pytest
import torch

from eamm_tpu_torch.ops import kp_expectation as kpx
from eamm_tpu_torch.ops import warp_cuda

torch.set_num_threads(1)


def _row_offsets(B, K, h, w, offset):
    """Each row's ten plane offsets in elements: pred and jmap as the heads
    pass them (slices of one [B, 5K, h, w] conv output starting ``offset``
    elements into its storage), grad_pred [B,K,h,w] and grad_jmap
    [B,K,4,h,w] contiguous."""
    P = h * w
    rows = []
    for b in range(B):
        for k in range(K):
            pred = offset + (b * 5 * K + k) * P
            jmap = [offset + (b * 5 * K + K + 4 * k + f) * P for f in range(4)]
            row = b * K + k
            rows.append([pred, *jmap, row * P,
                         *[(4 * row + f) * P for f in range(4)]])
    return rows


@pytest.mark.parametrize("h, w, offset", [(58, 58, 0), (57, 57, 0),
                                          (128, 128, 0), (58, 58, 1)],
                         ids=["58x58", "57x57", "128x128", "unaligned"])
def test_k3b_slots_cover_every_pixel_once(h, w, offset):
    B, K = 2, 10
    P = h * w
    plan = kpx.backward_plan(B, K, h, w, lambda groups, smem: 396)
    assert plan.groups == (0 if P > 4096 else 4)
    phases = set()
    for offsets in _row_offsets(B, K, h, w, offset):
        slots = kpx.row_slots(P, offsets)
        phases.add((slots.first, slots.grouped))
        held = kpx.backward_slots(P, slots, plan.groups)
        flat = np.concatenate([np.asarray(t, dtype=np.int64) for t in held])
        np.testing.assert_array_equal(np.sort(flat), np.arange(P))
        if plan.groups:
            assert max(len(t) for t in held) <= 4 * plan.groups + 1
        if slots.grouped:
            # every group starts on a 16-byte boundary of all ten planes
            starts = slots.first + 4 * np.arange(slots.groups)
            assert all(((o + starts) % 4 == 0).all() for o in offsets)
        assert slots.loose <= 6
    # planes 4 bytes off 16, or rows of P % 4 pixels (the four grad_jmap
    # planes of a row then start at four phases), go one pixel at a time
    if offset or P % 4:
        assert phases == {(0, False)}
    else:
        assert phases == {(0, True)}


def test_k3b_plan_paths_and_limits():
    resident = lambda groups, smem: 132 * (3 if groups else 1)  # noqa: E731
    assert kpx.backward_plan(3, 10, 13, 17, resident).groups == 1
    assert kpx.backward_plan(3, 10, 40, 40, resident).groups == 2
    assert kpx.backward_plan(256, 4, 58, 58, resident).groups == 4
    big = kpx.backward_plan(2, 10, 128, 128, resident)
    assert (big.groups, big.tables) == (0, True)
    assert big.smem_bytes == 8 * 128 * 128 + 4 * 256
    plan = kpx.backward_plan(96, 10, 58, 58, resident)
    assert plan.smem_bytes == 4 * (58 + 58) and plan.tables
    assert plan.blocks <= plan.resident
    assert plan.blocks * plan.rows_per_block >= 960
    assert (plan.blocks - 1) * plan.rows_per_block < 960
    with pytest.raises(ValueError, match="MAX_BACKWARD_PIXELS"):
        kpx.backward_plan(1, 1, 200, 200, resident)


def _grid(kind, B, Ho, Wo, rng):
    ys, xs = np.meshgrid((2 * np.arange(Ho) + 1) / Ho - 1,
                         (2 * np.arange(Wo) + 1) / Wo - 1, indexing="ij")
    identity = np.stack([xs, ys], -1)[None].repeat(B, 0)
    if kind == "identity":
        grid = identity
    elif kind == "shifted":
        grid = identity + rng.normal(0, 0.05, identity.shape) + 0.3
    else:
        grid = rng.uniform(-1.3, 1.3, identity.shape)
    return torch.tensor(grid, dtype=torch.float32)


@pytest.mark.parametrize("kind", ["identity", "shifted", "random"])
def test_k1b_bins_hold_every_corner(kind):
    """Every output pixel with a corner in a source tile is in one of the
    four bins that tile's block reads, and a pixel is binned exactly when
    some corner of it lies inside the image: at a ragged 29 x 45 source
    (no multiple of the 8x8 tile), two grids a source, both corner
    conventions."""
    rng = np.random.RandomState(0)
    B, group, H, W, Ho, Wo = 4, 2, 29, 45, 21, 33
    grid = _grid(kind, B, Ho, Wo, rng)
    T = warp_cuda.WIDE_TILE
    for align in (False, True):
        plan = warp_cuda.wide_backward_plan(B, Ho, Wo, group, H, W, 256, True)
        keys = warp_cuda.wide_backward_bins(grid, H, W, align, group).numpy()
        # the corners, recomputed plainly in float64 from the float32
        # pixel coordinates
        size = np.array([W, H], dtype=np.float32)
        g = grid.numpy()
        pix = ((g + 1) * 0.5 * (size - 1) if align
               else ((g + 1) * size - 1) * 0.5).astype(np.float64)
        base = np.floor(pix).reshape(-1, 2).astype(np.int64)
        source = np.repeat(np.arange(B) // group, Ho * Wo)
        binned = np.zeros(len(keys), dtype=bool)
        for dx in (0, 1):
            for dy in (0, 1):
                cx, cy = base[:, 0] + dx, base[:, 1] + dy
                inside = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
                binned |= inside
                ty, tx = cy // T, cx // T
                for o in np.flatnonzero(inside):
                    reads = {source[o] * plan.bins + (ty[o] + 1 - j) * plan.bins_x
                             + tx[o] + 1 - i for j in (0, 1) for i in (0, 1)}
                    assert keys[o] in reads, (kind, align, o)
        np.testing.assert_array_equal(keys >= 0, binned)
        assert keys.max() < (B // group) * plan.bins
        if kind == "identity":
            assert binned.all()


def test_k1b_workspace_layout():
    plan = warp_cuda.wide_backward_plan(24, 64, 64, 1, 64, 64, 256, True)
    assert (plan.tiles_x, plan.tiles_y, plan.bins_x, plan.bins) == (8, 8, 9, 81)
    assert plan.slices == 2
    n_bins, BP = 24 * 81, 24 * 64 * 64
    slot = 2 * n_bins + 1 + (2 * n_bins + 1) % 2
    assert slot % 2 == 0       # the (bin, rank) pairs are 8-byte loads
    assert plan.workspace == slot + 3 * BP + 4 * 2 * BP
    no_grid = warp_cuda.wide_backward_plan(24, 64, 64, 1, 64, 64, 256, False)
    assert no_grid.workspace == slot + 3 * BP
    bf = warp_cuda.wide_backward_plan(6, 13, 17, 3, 29, 45, 8, True)
    assert (bf.tiles_x, bf.tiles_y, bf.slices) == (6, 4, 1)
    assert bf.bins == 5 * 7
