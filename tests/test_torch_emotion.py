"""The port's emotion models against eamm_tpu's at narrow hourglass widths.

The port's model, which holds every head, is drawn with torch's default
initialization from a seed; every BN's running statistics are set to its
input's statistics on a seeded batch (``calibrate``), the weights go to
JAX through ``eamm_tpu.compat`` and come back to the port through
``convert.emotion_{k,map}_state_dict``, so both packages hold the
converted weights.  (JAX's own init compiled an init program per model,
~11 s each here.)  Random statistics would not do: means drawn like the
other models' kill every ReLU of these 20-odd BN layers, and the JAX
initial statistics leave a feature that barely depends on the image.  The
EmotionMap Jacobian heads, which JAX initialises to zero, get random
weights.  Both packages then run on the same numpy inputs: within 1e-3,
the per-module bound of PARITY.md.  This file holds EmotionK;
test_torch_emotion_map.py holds EmotionMap, the converters (checked as the
exact inverse of ``eamm_tpu.compat.convert_emotion_k`` /
``convert_emotion_map``) and the emotion one-euro filter (scale 100, which
amplifies small differences) against the JAX filter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from eamm_tpu.compat import convert_emotion_k, convert_emotion_map
from eamm_tpu.models import EmotionK as JEmotionK
from eamm_tpu.models.emotion import positional_embed as jax_positional_embed
from eamm_tpu_torch import convert
from eamm_tpu_torch.models import EmotionK, EmotionMap
from eamm_tpu_torch.models.emotion import positional_embed
from tests.test_torch_models import _close, _jit, _kp, _nchw

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once, and a torch per worker spinning a thread per core
    slows every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NARROW = dict(block_expansion=8, max_features=32, num_blocks=3)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return rng.rand(2, 128, 128, 3).astype(np.float32), _kp(rng, 2)


def _jax_args(x, kp):
    return jnp.asarray(x), jnp.asarray(kp["value"]), jnp.asarray(kp["jacobian"])


def _port_args(x, kp):
    return (_nchw(x), torch.from_numpy(kp["value"]),
            torch.from_numpy(kp["jacobian"]))


def calibrate(port, seed: int, size: int) -> dict:
    """Set every BN's running statistics of the emotion model ``port`` to
    those of its input on a seeded batch of 4 [size x size] frames, give
    EmotionMap's Jacobian heads random weights, and return the JAX
    variables of the result."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(4, 3, size, size).astype(np.float32))
    kp = {k: torch.from_numpy(v) for k, v in _kp(rng, 4).items()}
    is_map = isinstance(port, EmotionMap)
    with torch.no_grad():
        if is_map:
            for conv in (port.jacobian, port.jacobian_4):
                conv.weight.copy_(torch.from_numpy(0.01 * rng.randn(
                    *conv.weight.shape).astype(np.float32)))
        for m in port.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.momentum = None                  # cumulative: one batch
                m.reset_running_stats()
        port.train()
        port(x, kp["value"], kp["jacobian"], head="map" if is_map else "linear")
    port.eval()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    return (convert_emotion_map if is_map else convert_emotion_k)(sd)


def _build(jax_cls, port_cls, to_port, seed):
    """A JAX model, its variables with every head's parameters, and its
    port twin holding the same weights."""
    torch.manual_seed(seed)
    port = port_cls(**NARROW)
    v = calibrate(port, seed + 1, 128)
    port.load_state_dict(to_port(jax.tree.map(np.asarray, v)))
    return jax_cls(**NARROW), v, port


@pytest.fixture(scope="module")
def emotion_k():
    return _build(JEmotionK, EmotionK, convert.emotion_k_state_dict, 10)


def test_positional_embed_matches_jax():
    x = np.random.RandomState(0).uniform(-1, 1, (3, 10, 6)).astype(np.float32)
    ours = positional_embed(torch.from_numpy(x))
    assert ours.shape == (3, 10, 126)
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(jax_positional_embed(jnp.asarray(x))),
                               atol=1e-6)


@pytest.mark.parametrize("head", ["linear", "linear_10", "linear_4",
                                  "linear_np_4", "linear_np_10"])
def test_emotion_k_heads_match_jax(emotion_k, head):
    jm, v, port = emotion_k
    x, kp = _inputs(11)
    ref, ref_fake = _jit(jm.apply, head=head)(v, *_jax_args(x, kp))
    with torch.no_grad():
        ours, fake = port(*_port_args(x, kp), head=head)
    n = 10 if head.endswith("_10") else 4
    assert ours["value"].shape == (2, n, 2)
    _close(fake, ref_fake)
    _close(ours["value"], ref["value"])
    _close(ours["jacobian"], ref["jacobian"])


def test_emotion_k_feature_and_emotion_feature_match_jax(emotion_k):
    jm, v, port = emotion_k
    x, kp = _inputs(12)
    jx, jv, jj = _jax_args(x, kp)
    ref_feat = _jit(jm.apply, method=JEmotionK.feature)(v, jx)
    ref, ref_fake = _jit(jm.apply, method=JEmotionK.emotion_feature)(
        v, ref_feat, jv, jj)
    tx, tv, tj = _port_args(x, kp)
    with torch.no_grad():
        feat = port.feature(tx)
        ours, fake = port.emotion_feature(torch.from_numpy(
            np.array(ref_feat)), tv, tj)
    assert feat.shape == (2, 512)
    _close(feat, ref_feat)
    _close(fake, ref_fake)
    _close(ours["value"], ref["value"])
    _close(ours["jacobian"], ref["jacobian"])
