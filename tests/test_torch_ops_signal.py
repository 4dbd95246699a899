"""The one-euro filter and the MFCC frontend of eamm_tpu_torch against
their eamm_tpu counterparts on the same numpy inputs (CPU), at
tests/test_torch_ops.py's bounds: the filter to float32 rounding, the MFCC
frames to 1e-4 relative."""
import importlib

import numpy as np
import pytest
import jax.numpy as jnp

from eamm_tpu.ops import filters as jax_filters
from eamm_tpu_torch.ops import filters, mfcc
from tests.test_torch_ops import _close, _t, one_thread  # noqa: F401

# eamm_tpu.ops re-exports a function named mfcc over its module
jax_mfcc = importlib.import_module("eamm_tpu.ops.mfcc")


@pytest.mark.parametrize("scale", [1.0, 10.0])
def test_one_euro_filter(scale):
    rng = np.random.RandomState(5)
    x = np.cumsum(rng.randn(40, 10, 2), axis=0).astype(np.float32) * 0.05
    kw = dict(mincutoff=0.05, beta=8.0, freq=100, scale=scale)
    _close(filters.one_euro_filter(_t(x), **kw),
           jax_filters.one_euro_filter(jnp.asarray(x), **kw))
    np.testing.assert_array_equal(filters.one_euro_filter_np(x, **kw),
                                  jax_filters.one_euro_filter_np(x, **kw))


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
