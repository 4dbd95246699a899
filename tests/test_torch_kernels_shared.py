"""K4's plain version (the shared-source warp) against the TPU kernel it
replaces, as tests/test_torch_kernels.py runs K1's; the later wrappers'
refusals, and no launch counted on the CPU."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from eamm_tpu.ops import warp_pallas
from eamm_tpu_torch.ops import kp_expectation as kpx
from eamm_tpu_torch.ops import warp_cuda
from tests.test_torch_kernels import ATOL, _interpret, one_thread  # noqa: F401


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
