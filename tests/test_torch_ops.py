"""eamm_tpu_torch ops against their eamm_tpu counterparts on the same numpy
inputs (CPU).  Elementwise ops agree to float32 rounding (atol 1e-5); the
MFCC frontend to 1e-4 relative, since the two FFTs sum in other orders
(the filter and the MFCC frontend are in test_torch_ops_signal.py)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from eamm_tpu.ops import antialias as jax_antialias
from eamm_tpu.ops import grid as jax_grid
from eamm_tpu.ops import motion as jax_motion
from eamm_tpu.ops import warp as jax_warp
from eamm_tpu_torch.ops import antialias, grid, motion, warp


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


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(ours, ref, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=atol,
                               rtol=rtol)


def _kp(rng, B, K=10, jac_noise=0.1):
    value = rng.uniform(-1, 1, (B, K, 2)).astype(np.float32)
    jac = (np.tile(np.eye(2, dtype=np.float32), (B, K, 1, 1))
           + jac_noise * rng.randn(B, K, 2, 2).astype(np.float32))
    return value, jac


# ------------------------------------------------------------------ grid

def test_grid_ops():
    """Independent of what ran before it in the process: torch runs on the
    module fixture's one thread with explicit float32 inputs, JAX under
    float32, standard promotion and full matmul precision whatever an
    earlier test set, and JAX gets copies, never views of torch memory."""
    rng = np.random.RandomState(0)
    with jax.enable_x64(False), jax.numpy_dtype_promotion("standard"), \
            jax.default_matmul_precision("highest"):
        _close(grid.make_coordinate_grid(7, 5, torch.float32),
               jax_grid.make_coordinate_grid(7, 5, jnp.float32))
        kp = rng.uniform(-1, 1, (2, 10, 2)).astype(np.float32)
        _close(grid.kp2gaussian(_t(kp), (16, 12), 0.01),
               jax_grid.kp2gaussian(jnp.array(kp), (16, 12), 0.01))
        pred = rng.randn(2, 10, 9, 11).astype(np.float32)
        heat = grid.heatmap_softmax(_t(pred), 0.1)
        _close(heat, jax_grid.heatmap_softmax(jnp.array(pred), 0.1))
        _close(grid.gaussian2kp(heat),
               jax_grid.gaussian2kp(jnp.array(heat.numpy())))


# ------------------------------------------------------------------ warp

@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample(padding_mode, align_corners):
    """Grids in (-1.2, 1.2) put corners outside the image."""
    rng = np.random.RandomState(1)
    img = rng.randn(3, 9, 7, 5).astype(np.float32)
    g = rng.uniform(-1.2, 1.2, (3, 6, 8, 2)).astype(np.float32)
    ours = warp.grid_sample(_t(img), _t(g), padding_mode=padding_mode,
                            align_corners=align_corners)
    ref = jax_warp.grid_sample(jnp.asarray(img), jnp.asarray(g),
                               padding_mode=padding_mode,
                               align_corners=align_corners)
    _close(ours, ref)


def test_grid_sample_rejects_bad_shapes():
    """A grid batch the image batch does not divide, and a padding mode
    that neither package has."""
    with pytest.raises(ValueError):
        warp.grid_sample(torch.zeros(2, 4, 4, 3), torch.zeros(3, 4, 4, 2))
    with pytest.raises(ValueError):
        warp.grid_sample(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 2),
                         padding_mode="wrap")


def test_resize_and_pooling():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 12, 10, 3).astype(np.float32)
    for hw in [(20, 16), (5, 7)]:
        _close(warp.resize_bilinear(_t(x), hw),
               jax_warp.resize_bilinear(jnp.asarray(x), hw))
    _close(warp.upsample_nearest_2x(_t(x)),
           jax_warp.upsample_nearest_2x(jnp.asarray(x)))
    _close(warp.avg_pool_2x(_t(x)), jax_warp.avg_pool_2x(jnp.asarray(x)))


# ------------------------------------------------------------- antialias

def test_antialias_downsample():
    rng = np.random.RandomState(3)
    x = rng.rand(2, 32, 24, 3).astype(np.float32)
    _close(antialias.antialias_downsample(_t(x), 0.25),
           jax_antialias.antialias_downsample(jnp.asarray(x), 0.25))
    assert antialias.antialias_downsample(_t(x), 1.0).shape == x.shape


# ---------------------------------------------------------------- motion

def test_motion_ops():
    rng = np.random.RandomState(4)
    vd, jd = _kp(rng, 2)
    vs, js = _kp(rng, 2)
    _close(motion.inv2x2(_t(jd)), jax_motion.inv2x2(jnp.asarray(jd)))
    _close(motion.sparse_motions((8, 6), _t(vd), _t(vs), _t(jd), _t(js)),
           jax_motion.sparse_motions((8, 6), jnp.asarray(vd), jnp.asarray(vs),
                                     jnp.asarray(jd), jnp.asarray(js)))
    v0, j0 = _kp(rng, 1)
    for relative in (False, True):
        ours = motion.normalize_kp(
            {"value": _t(vs[0]), "jacobian": _t(js[0])},
            {"value": _t(vd), "jacobian": _t(jd)},
            {"value": _t(v0[0]), "jacobian": _t(j0[0])},
            use_relative_movement=relative, use_relative_jacobian=relative)
        ref = jax_motion.normalize_kp(
            {"value": jnp.asarray(vs[0]), "jacobian": jnp.asarray(js[0])},
            {"value": jnp.asarray(vd), "jacobian": jnp.asarray(jd)},
            {"value": jnp.asarray(v0[0]), "jacobian": jnp.asarray(j0[0])},
            use_relative_movement=relative, use_relative_jacobian=relative)
        for k in ("value", "jacobian"):
            _close(ours[k], ref[k])
