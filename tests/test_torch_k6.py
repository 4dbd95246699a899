"""K6's plain version (``ops/warp_cuda.py::grid_sample_twolevel_b16_plain``)
against the TPU kernel it replaces, ``benchmarks/bench_warp_variants.py::
twolevel_b16``, run in Pallas interpret mode on the CPU.

The bound is bitwise for bfloat16 images.  For a float32 image the XLA
CPU reference contracts some of its float32 products and sums into fused
multiply-adds, which the plain version and the kernel do not (each
product and sum rounds on its own, as the TPU kernel's formula reads), so
a stated number of elements differ: each by at most one bfloat16 ulp at
the image's scale, the most one flipped rounding of a bfloat16 row can
move an output weighted by x tents that sum to at most 1.  The CUDA
kernel runs only on the card, where chip_smoke.py holds it to this plain
version."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from benchmarks.bench_warp_variants import twolevel_b16
from eamm_tpu_torch.ops import warp_cuda


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _interpret(image, grid, tile):
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(twolevel_b16(image, grid, tile=tile)
                          .astype(jnp.float32))


# (image shape, grid shape, tile, image dtype, elements allowed to differ
# by at most one bf16 ulp at the image's scale): bf16 [1,8,8,16] by
# [4,8,8,2], Bi = 2 grouping, a float32 image (676 of its 4096 elements
# differ: 577 by one float32 ulp, the largest by 256), and 5 * 7 = 35
# pixels, not a multiple of the tile
CASES = [((1, 8, 8, 16), (4, 8, 8, 2), 32, "bfloat16", 0),
         ((2, 8, 8, 16), (4, 8, 8, 2), 32, "bfloat16", 0),
         ((1, 8, 8, 16), (4, 8, 8, 2), 32, "float32", 676),
         ((1, 16, 8, 16), (3, 5, 7, 2), 32, "bfloat16", 0)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_matches_twolevel_b16(case):
    img_shape, grid_shape, tile, dtype, allowed = CASES[case]
    rng = np.random.RandomState(60 + case)
    img = rng.randn(*img_shape).astype(np.float32)
    g = rng.uniform(-1.05, 1.05, grid_shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = _interpret(jnp.asarray(img).astype(jdt), jnp.asarray(g), tile)
    ours = warp_cuda.grid_sample_twolevel_b16_plain(
        torch.from_numpy(img).to(tdt), torch.from_numpy(g)).float().numpy()
    assert ours.shape == ref.shape
    err = np.abs(ours - ref)
    assert int((err > 0).sum()) <= allowed, f"{int((err > 0).sum())} differ"
    bf16_ulp = 2.0 ** (np.floor(np.log2(np.abs(img).max())) - 7)
    assert err.max() <= bf16_ulp


def test_entry_point_takes_the_plain_version_on_the_cpu():
    """On a CPU tensor the entry point is the plain version, counts no
    launch, checks ``tile`` and ignores it; the y pass's bfloat16 rounding
    is what sets it apart from the plain bilinear warp."""
    rng = np.random.RandomState(70)
    img = torch.from_numpy(rng.randn(2, 8, 8, 16).astype(np.float32))
    g = torch.from_numpy(rng.uniform(-1.05, 1.05, (4, 8, 8, 2))
                         .astype(np.float32))
    before = warp_cuda.grid_sample_twolevel_b16.launches
    got = warp_cuda.grid_sample_twolevel_b16(img, g, tile=64)
    assert warp_cuda.grid_sample_twolevel_b16.launches == before
    assert torch.equal(got, warp_cuda.grid_sample_twolevel_b16_plain(img, g))
    assert torch.equal(got, torch.ops.eamm.warp_wide_b16(img, g))
    assert not torch.equal(got, warp_cuda.grid_sample_plain(img, g))
    with pytest.raises(ValueError, match="tile"):
        warp_cuda.grid_sample_twolevel_b16(img, g, tile=0)
    with pytest.raises(ValueError, match="divide"):
        warp_cuda.grid_sample_twolevel_b16(img, g[:3])
    with pytest.raises(TypeError):
        warp_cuda.grid_sample_twolevel_b16(img.double(), g)
