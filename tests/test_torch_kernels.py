"""The plain versions of the port's CUDA kernels against the TPU kernels they
replace, run as the JAX package's own tests run them on the CPU (Pallas
interpret mode, exact f32 products), at atol 1e-5.

The CUDA kernels themselves run only on the card; chip_smoke.py holds them
to these plain versions there.  Here the wrappers must take the plain
version for CPU tensors and reject what the kernels do not take."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import eamm_tpu.ops.kp_expectation as jax_kpx
from eamm_tpu.ops import kp_pallas, warp_pallas
from eamm_tpu_torch.ops import kp_expectation as kpx
from eamm_tpu_torch.ops import warp_cuda

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once, and a torch per worker spinning a thread per core
    slows every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = 1e-5


def _interpret(fn, *args, **kw):
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args, **kw))


# (image shape, grid shape, tile): a shared source, Bi=2 grouping, and a
# pixel count (5*7=35) that is not a multiple of the TPU tile
WIDE_CASES = [((1, 8, 8, 128), (4, 8, 8, 2), 32),
              ((2, 8, 8, 128), (4, 8, 8, 2), 32),
              ((1, 16, 8, 128), (3, 5, 7, 2), 32)]
NARROW_CASES = [((1, 16, 8, 3), (6, 5, 7, 2), 32),
                ((2, 8, 8, 3), (6, 4, 4, 2), 16)]


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("case", range(len(WIDE_CASES)))
def test_wide_warp_plain_matches_twolevel_pallas(case, align_corners):
    img_shape, grid_shape, tile = WIDE_CASES[case]
    rng = np.random.RandomState(case)
    img = rng.randn(*img_shape).astype(np.float32)
    g = rng.uniform(-1.2, 1.2, grid_shape).astype(np.float32)
    ref = _interpret(warp_pallas.grid_sample_twolevel_pallas,
                     jnp.asarray(img), jnp.asarray(g),
                     align_corners=align_corners, tile=tile, exact=True)
    ours = warp_cuda.grid_sample_wide(torch.from_numpy(img),
                                      torch.from_numpy(g), align_corners)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("case", range(len(NARROW_CASES)))
def test_narrow_warp_plain_matches_smallc_pallas(case, align_corners):
    img_shape, grid_shape, tile = NARROW_CASES[case]
    rng = np.random.RandomState(10 + case)
    img = rng.randn(*img_shape).astype(np.float32)
    g = rng.uniform(-1.2, 1.2, grid_shape).astype(np.float32)
    ref = _interpret(warp_pallas.grid_sample_smallc_pallas,
                     jnp.asarray(img), jnp.asarray(g),
                     align_corners=align_corners, tile=tile, exact=True)
    ours = warp_cuda.grid_sample_narrow(torch.from_numpy(img),
                                        torch.from_numpy(g), align_corners)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)


def test_warp_grouping_reads_the_right_source():
    """Grid b reads source b // (B // Bi): swapping the sources changes
    the result, so a wrong index cannot pass."""
    rng = np.random.RandomState(20)
    img = torch.from_numpy(rng.randn(2, 8, 8, 3).astype(np.float32))
    g = torch.from_numpy(rng.uniform(-1, 1, (4, 4, 4, 2)).astype(np.float32))
    out = warp_cuda.grid_sample_narrow(img, g)
    rep = warp_cuda.grid_sample_narrow(img.repeat_interleave(2, 0), g)
    torch.testing.assert_close(out, rep, rtol=0, atol=0)
    swapped = warp_cuda.grid_sample_narrow(img.flip(0), g)
    assert (out - swapped).abs().max() > 1e-3


def test_warp_wrappers_reject_what_the_kernels_do_not_take():
    img, g = torch.zeros(1, 8, 8, 12), torch.zeros(2, 4, 4, 2)
    with pytest.raises(ValueError):
        warp_cuda.grid_sample_wide(torch.zeros(1, 8, 8, 12, device="meta"),
                                   g.to("meta"))       # C % 8 != 0
    with pytest.raises(ValueError):
        warp_cuda.grid_sample_narrow(img.to("meta"), g.to("meta"))   # C > 8
    with pytest.raises(ValueError):
        warp_cuda.grid_sample_narrow(torch.zeros(2, 8, 8, 3),
                                     torch.zeros(3, 4, 4, 2))
    with pytest.raises(ValueError):      # neither CPU nor CUDA
        warp_cuda.grid_sample_narrow(torch.zeros(1, 8, 8, 3, device="meta"),
                                     g.to("meta"))


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


# (source shape, grids shape, tile): the JAX package's own case, and any C
# (35: neither a multiple of 8 nor <= 8) at a pixel count (3*5*7) that is
# not a multiple of the TPU tile
SHARED_CASES = [((16, 16, 8), (3, 8, 8, 2), 128),
                ((16, 12, 35), (3, 5, 7, 2), 64)]


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("case", range(len(SHARED_CASES)))
def test_shared_warp_plain_matches_pallas(case, align_corners):
    src_shape, grid_shape, tile = SHARED_CASES[case]
    rng = np.random.RandomState(30 + case)
    src = rng.randn(*src_shape).astype(np.float32)
    g = rng.uniform(-1.2, 1.2, grid_shape).astype(np.float32)
    ref = _interpret(warp_pallas.grid_sample_shared, jnp.asarray(src),
                     jnp.asarray(g), align_corners=align_corners, tile=tile,
                     exact=True)
    for exact in (False, True):         # both give the float32 result
        ours = warp_cuda.grid_sample_shared(torch.from_numpy(src),
                                            torch.from_numpy(g),
                                            align_corners, exact)
        np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)


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


def test_new_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):                  # source not [Hs,Ws,C]
        warp_cuda.grid_sample_shared(torch.zeros(1, 8, 8, 3),
                                     torch.zeros(2, 4, 4, 2))
    with pytest.raises(ValueError):                  # neither CPU nor CUDA
        warp_cuda.grid_sample_shared(torch.zeros(8, 8, 35, device="meta"),
                                     torch.zeros(2, 4, 4, 2, device="meta"))
    with pytest.raises(ValueError):                  # jmap not [B,K,4,h,w]
        kpx.kp_expectation_fused(torch.zeros(1, 2, 5, 5),
                                 torch.zeros(1, 2, 2, 5, 5), 0.1)
    with pytest.raises(ValueError):                  # neither CPU nor CUDA
        kpx.kp_expectation_fused(torch.zeros(1, 2, 5, 5, device="meta"),
                                 torch.zeros(1, 2, 4, 5, 5, device="meta"), 0.1)


def test_launch_counters_untouched_on_cpu():
    wrappers = (warp_cuda.grid_sample_wide, warp_cuda.grid_sample_narrow,
                warp_cuda.grid_sample_shared, kpx.kp_expectation,
                kpx.kp_expectation_fused)
    before = [w.launches for w in wrappers]
    warp_cuda.grid_sample_wide(torch.zeros(1, 4, 4, 8), torch.zeros(1, 2, 2, 2))
    warp_cuda.grid_sample_narrow(torch.zeros(1, 4, 4, 3),
                                 torch.zeros(1, 2, 2, 2))
    warp_cuda.grid_sample_shared(torch.zeros(4, 4, 35), torch.zeros(2, 2, 2, 2))
    kpx.kp_expectation(torch.zeros(1, 2, 3, 3), torch.zeros(1, 2, 4, 3, 3), 0.1)
    kpx.kp_expectation_fused(torch.zeros(1, 2, 3, 3),
                             torch.zeros(1, 2, 4, 3, 3), 0.1, True)
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_narrow_shared_memory_check(dtype):
    """The narrow kernel keeps its source in shared memory: the JAX kernel's
    documented sources (H*W <= 4096, C <= 8) fit in both dtypes, a 256x256
    one does not, and the wrapper refuses it before any launch."""
    for C in (1, 3, 8):
        assert warp_cuda.narrow_smem_bytes(64, 64, C, dtype) \
            <= warp_cuda.SMEM_LIMIT
    with pytest.raises(ValueError):
        warp_cuda.narrow_smem_bytes(256, 256, 3, dtype)
    with pytest.raises(ValueError, match="shared memory"):
        warp_cuda.grid_sample_narrow(
            torch.zeros(1, 256, 256, 3, dtype=dtype, device="meta"),
            torch.zeros(2, 4, 4, 2, dtype=dtype, device="meta"))


def test_capture_helper_returns_the_models_warp_arguments():
    """chip_smoke.py's capture of the main path's warp arguments, on the
    CPU at TINY_CONFIG: one decode chunk's, at the shapes the models pass,
    and the models' warps are restored afterwards."""
    import chip_smoke
    from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
    from eamm_tpu_torch.models import dense_motion, generator
    pipe = EammPipeline.from_random(chip_smoke.TINY_CONFIG, 0, PipelineOptions(
        device="cpu", frame_chunk=8, time_bucket=8))
    captured = chip_smoke.capture_warp_inputs(pipe, seconds=1.0)
    gen = chip_smoke.TINY_CONFIG["model_params"]["generator_params"]
    K = chip_smoke.TINY_CONFIG["model_params"]["common_params"]["num_kp"]
    width = min(gen["max_features"],
                gen["block_expansion"] * 2 ** gen["num_down_blocks"])
    image, grid = captured["warp_narrow"]
    assert image.shape == (1, 64, 64, 3)
    assert grid.shape == (8 * (K + 1), 64, 64, 2)
    image, grid = captured["warp_wide"]
    assert image.shape == (1, 64, 64, width) and grid.shape == (8, 64, 64, 2)
    assert dense_motion.grid_sample_narrow is warp_cuda.grid_sample_narrow
    assert generator.grid_sample_wide is warp_cuda.grid_sample_wide
