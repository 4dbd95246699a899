"""K3's and K5's plain versions (the keypoint expectation, plain and
fused) against the TPU kernels they replace, as tests/test_torch_kernels.py
runs the warps', and K5's launch plan."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import eamm_tpu.ops.kp_expectation as jax_kpx
from eamm_tpu.ops import kp_pallas
from eamm_tpu_torch.ops import kp_expectation as kpx
from tests.test_torch_kernels import ATOL, one_thread  # noqa: F401


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 10, 58, 58)])
def test_kp_expectation_plain_matches_pallas(shape, monkeypatch):
    monkeypatch.setattr(jax_kpx, "_INTERPRET", True)
    rng = np.random.RandomState(0)
    B, K, h, w = shape
    pred = rng.randn(B, K, h, w).astype(np.float32)
    jmap = rng.randn(B, K, 4, h, w).astype(np.float32)
    ref_v, ref_j = jax_kpx.kp_expectation(jnp.asarray(pred), jnp.asarray(jmap),
                                          0.1)
    value, jac = kpx.kp_expectation(torch.from_numpy(pred),
                                    torch.from_numpy(jmap), 0.1)
    np.testing.assert_allclose(value.numpy(), np.asarray(ref_v), atol=ATOL,
                               rtol=1e-5)
    np.testing.assert_allclose(jac.numpy(), np.asarray(ref_j), atol=ATOL,
                               rtol=1e-5)


def test_kp_expectation_reads_conv_output_slices():
    """The heads pass y[:, :K] and y[:, K:] of one [B, 5K, h, w] conv
    output; the strided views give what the copies give."""
    rng = np.random.RandomState(1)
    y = torch.from_numpy(rng.randn(3, 50, 9, 11).astype(np.float32))
    views = kpx.kp_expectation(y[:, :10], y[:, 10:].view(3, 10, 4, 9, 11), 0.1)
    copies = kpx.kp_expectation(y[:, :10].clone(),
                                y[:, 10:].reshape(3, 10, 4, 9, 11).clone(), 0.1)
    for a, b in zip(views, copies):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        kpx.kp_expectation(y[:, :10], y[:, 10:30].view(3, 10, 2, 9, 11), 0.1)
    with pytest.raises(ValueError):      # neither CPU nor CUDA
        kpx.kp_expectation(y[:, :10].to("meta"),
                           y[:, 10:].reshape(3, 10, 4, 9, 11).to("meta"), 0.1)


@pytest.mark.parametrize("shape,want_heatmap,dtype",
                         [((3, 10, 58, 58), True, np.float32),
                          ((3, 2, 58, 58), False, np.float32),
                          ((2, 3, 13, 17), True, "bfloat16"),
                          ((2, 3, 13, 17), True, "bfloat16 pred")])
def test_kp_expectation_fused_plain_matches_pallas(shape, want_heatmap, dtype):
    """value and jacobian within 1e-5, the float32 heatmap within 1e-6
    (tests/test_kp_pallas.py's bounds); a bfloat16 heatmap within one
    bfloat16 rounding (rtol 1e-2).  "bfloat16 pred": a bfloat16 prediction
    with a float32 jmap."""
    rng = np.random.RandomState(2)
    B, K, h, w = shape
    pred = rng.randn(B, K, h, w).astype(np.float32)
    jmap = rng.randn(B, K, 4, h, w).astype(np.float32)
    jp, jj = jnp.asarray(pred), jnp.asarray(jmap)
    tp, tj = torch.from_numpy(pred), torch.from_numpy(jmap)
    if dtype == "bfloat16":
        jp, jj = jp.astype(jnp.bfloat16), jj.astype(jnp.bfloat16)
        tp, tj = tp.bfloat16(), tj.bfloat16()
    if dtype == "bfloat16 pred":
        jp, tp = jp.astype(jnp.bfloat16), tp.bfloat16()
    ref = kp_pallas.kp_expectation_fused(jp, jj, 0.1,
                                         want_heatmap=want_heatmap,
                                         interpret=True)
    value, jac, heat = kpx.kp_expectation_fused(tp, tj, 0.1, want_heatmap)
    np.testing.assert_allclose(value.numpy(), np.asarray(ref[0]), atol=ATOL)
    np.testing.assert_allclose(jac.numpy(), np.asarray(ref[1]), atol=ATOL)
    if not want_heatmap:
        assert heat is None and ref[2] is None
    elif dtype != np.float32:
        assert heat.dtype == torch.bfloat16
        np.testing.assert_allclose(heat.float().numpy(),
                                   np.asarray(ref[2].astype(jnp.float32)),
                                   rtol=1e-2, atol=1e-6)
    else:
        np.testing.assert_allclose(heat.numpy(), np.asarray(ref[2]), atol=1e-6)


def test_kp_fused_launch_plan():
    """The fused kernel's launch: the row's float32 logits in shared memory
    when the heatmap is wanted (in either dtype), the coordinate tables
    where they fit beside them, persistent blocks balanced over the rows
    (2560 rows over 528 resident blocks: 512 blocks of 5 rows); a row past
    MAX_FUSED_PIXELS is refused before the card is asked anything."""
    asked = []

    def resident(n):
        asked.append(n)
        return n_resident

    n_resident = 528
    plan = kpx.fused_plan(256, 10, 58, 58, True, resident)
    assert plan == kpx.FusedPlan(smem_bytes=4 * (58 * 58 + 58 + 58),
                                 tables=True, resident=528, blocks=512,
                                 rows_per_block=5)
    assert asked == [plan.smem_bytes]
    assert kpx.fused_plan(256, 10, 58, 58, False,
                          resident).smem_bytes == 4 * (58 + 58)
    plan = kpx.fused_plan(1, 10, 58, 58, True, resident)
    assert (plan.blocks, plan.rows_per_block) == (10, 1)   # fewer rows
    plan = kpx.fused_plan(3, 2, 13, 17, True, resident)
    assert (plan.smem_bytes, plan.blocks, plan.rows_per_block) == (
        4 * (221 + 30), 6, 1)
    n_resident = 132
    plan = kpx.fused_plan(1, 2, 192, 256, True, resident)
    assert 192 * 256 == kpx.MAX_FUSED_PIXELS
    assert plan.smem_bytes == 4 * (192 * 256 + 192 + 256) \
        <= kpx.FUSED_SMEM_BUDGET and plan.tables
    assert (plan.blocks, plan.rows_per_block) == (2, 1)
    plan = kpx.fused_plan(300, 10, 192, 256, True, resident)
    assert (plan.blocks, plan.rows_per_block) == (131, 23)
    # the largest row of an extreme aspect: the logits fit, the tables not
    plan = kpx.fused_plan(1, 1, 2, 24576, True, resident)
    assert (plan.smem_bytes, plan.tables) == (4 * 2 * 24576, False)
    asked.clear()
    for heat in (True, False):
        with pytest.raises(ValueError, match="MAX_FUSED_PIXELS"):
            kpx.fused_plan(1, 2, 192, 257, heat, resident)
    assert asked == []
