"""The plain versions of the port's CUDA kernels against the TPU kernels they
replace, run as the JAX package's own tests run them on the CPU (Pallas
interpret mode, exact f32 products), at atol 1e-5.

The CUDA kernels themselves run only on the card; chip_smoke.py holds them
to these plain versions there.  Here the wrappers must take the plain
version for CPU tensors and reject what the kernels do not take.  This
file holds K1 (the wide warp); K2 is in test_torch_kernels_narrow.py, K3
and K5 in test_torch_kernels_kp.py, K4 in test_torch_kernels_shared.py,
which take their helpers from here."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from eamm_tpu.ops import warp_pallas
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
