"""K2's plain version (the narrow warp) against the TPU kernel it replaces,
in Pallas interpret mode as tests/test_torch_kernels.py runs K1's; its
shared-memory check, and chip_smoke.py's capture of the main path's warp
arguments."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from eamm_tpu.ops import warp_pallas
from eamm_tpu_torch.ops import warp_cuda
from tests.test_torch_kernels import ATOL, _interpret, one_thread  # noqa: F401


NARROW_CASES = [((1, 16, 8, 3), (6, 5, 7, 2), 32),
                ((2, 8, 8, 3), (6, 4, 4, 2), 16)]


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
