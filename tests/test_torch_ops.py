"""eamm_tpu_torch ops against their eamm_tpu counterparts on the same numpy
inputs (CPU).  Elementwise ops agree to float32 rounding (atol 1e-5); the
MFCC frontend to 1e-4 relative, since the two FFTs sum in other orders."""
import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from eamm_tpu.ops import antialias as jax_antialias
from eamm_tpu.ops import filters as jax_filters
from eamm_tpu.ops import grid as jax_grid
from eamm_tpu.ops import motion as jax_motion
from eamm_tpu.ops import warp as jax_warp
from eamm_tpu_torch.ops import antialias, filters, grid, mfcc, motion, warp

# eamm_tpu.ops re-exports a function named mfcc over its module
jax_mfcc = importlib.import_module("eamm_tpu.ops.mfcc")

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
    rng = np.random.RandomState(0)
    _close(grid.make_coordinate_grid(7, 5), jax_grid.make_coordinate_grid(7, 5))
    kp = rng.uniform(-1, 1, (2, 10, 2)).astype(np.float32)
    _close(grid.kp2gaussian(_t(kp), (16, 12), 0.01),
           jax_grid.kp2gaussian(jnp.asarray(kp), (16, 12), 0.01))
    pred = rng.randn(2, 10, 9, 11).astype(np.float32)
    heat = grid.heatmap_softmax(_t(pred), 0.1)
    _close(heat, jax_grid.heatmap_softmax(jnp.asarray(pred), 0.1))
    _close(grid.gaussian2kp(heat),
           jax_grid.gaussian2kp(jnp.asarray(heat.numpy())))


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
    with pytest.raises(ValueError):
        warp.grid_sample(torch.zeros(2, 4, 4, 3), torch.zeros(3, 4, 4, 2))
    with pytest.raises(ValueError):
        warp.grid_sample(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 2),
                         padding_mode="reflection")


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


# --------------------------------------------------------------- filters

@pytest.mark.parametrize("scale", [1.0, 10.0])
def test_one_euro_filter(scale):
    rng = np.random.RandomState(5)
    x = np.cumsum(rng.randn(40, 10, 2), axis=0).astype(np.float32) * 0.05
    kw = dict(mincutoff=0.05, beta=8.0, freq=100, scale=scale)
    _close(filters.one_euro_filter(_t(x), **kw),
           jax_filters.one_euro_filter(jnp.asarray(x), **kw))
    np.testing.assert_array_equal(filters.one_euro_filter_np(x, **kw),
                                  jax_filters.one_euro_filter_np(x, **kw))


# ------------------------------------------------------------------ mfcc

def test_mfcc_windows():
    rng = np.random.RandomState(6)
    sig = (0.1 * rng.randn(16000)).astype(np.float32)
    ours = mfcc.audio_to_mfcc_windows(_t(sig))
    ref = jax_mfcc.audio_to_mfcc_windows(jnp.asarray(sig))
    assert ours.shape == ref.shape
    _close(ours, ref, atol=1e-4, rtol=1e-4)


def test_mfcc_golden_vector():
    """The golden rows pinned in tests/test_ops_mfcc.py (a 30 ms 1 kHz
    cosine, float64-derived), at the same tolerance as there."""
    t = np.arange(480) / 16000.0
    sig = np.cos(2 * np.pi * 1000.0 * t).astype(np.float32)
    golden = np.array([
        [2.7313466, -3.17523693, -16.9037009, -29.98938097, -8.62911928,
         20.28014545, 28.31154428, 4.55892341, -22.31792712, -25.31335459,
         -2.77878332, 17.27836534, 15.61339112],
        [2.47535253, 19.95154009, -19.63221411, -32.00167159, -10.1640156,
         20.33081106, 27.44741469, 4.33265794, -21.52695914, -23.61716691,
         -2.28591608, 16.14658459, 13.76300669]])
    np.testing.assert_allclose(mfcc.mfcc(_t(sig)).numpy(), golden, atol=2e-4,
                               rtol=1e-5)
    np.testing.assert_array_equal(mfcc.mel_filterbank(),
                                  jax_mfcc.mel_filterbank())


@pytest.mark.parametrize("n", [0, 399, 16000, 16001, 160000])
def test_mfcc_shape_arithmetic(n):
    assert mfcc.num_windows_for_samples(n) == \
        jax_mfcc.num_windows_for_samples(n)
    t = max(1, mfcc.num_windows_for_samples(n))
    assert mfcc.min_samples_for_windows(t) == \
        jax_mfcc.min_samples_for_windows(t)
