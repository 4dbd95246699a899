"""The port's emotion models against eamm_tpu's at narrow hourglass widths.

The JAX module is initialised with every head and converted through
``convert.emotion_{k,map}_state_dict`` into the port; there every BN's
running statistics are set to its input's statistics on a seeded batch
(``calibrate``), and the weights go back to JAX through
``eamm_tpu.compat``.  Random statistics would not do: means drawn like the
other models' kill every ReLU of these 20-odd BN layers, and the JAX
initial statistics leave a feature that barely depends on the image.  The
EmotionMap Jacobian heads, which JAX initialises to zero, get random
weights.  Both packages then run on the same numpy inputs: within 1e-3,
the per-module bound of PARITY.md.  The converters are checked as the exact inverse of
``eamm_tpu.compat.convert_emotion_k`` / ``convert_emotion_map``, and the
emotion one-euro filter (scale 100, which amplifies small differences)
against the JAX filter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from eamm_tpu.compat import convert_emotion_k, convert_emotion_map
from eamm_tpu.models import EmotionK as JEmotionK, EmotionMap as JEmotionMap
from eamm_tpu.models.emotion import positional_embed as jax_positional_embed
from eamm_tpu.ops.filters import one_euro_filter as jax_one_euro_filter
from eamm_tpu_torch import config as cfg
from eamm_tpu_torch import convert
from eamm_tpu_torch.models import EmotionK, EmotionMap
from eamm_tpu_torch.models.emotion import positional_embed
from eamm_tpu_torch.ops.filters import one_euro_filter
from tests.test_compat_emotion import TEmotionK
from tests.test_compat_emotion_map import TEmotionMap
from tests.test_compat_parity import _randomize_bn_stats
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
    """A JAX model with every head's parameters and its port twin."""
    x, kp = _inputs(seed)
    jm = jax_cls(**NARROW)
    v = _jit(jm.init, head="all")(jax.random.PRNGKey(seed), *_jax_args(
        x[:1], {k: a[:1] for k, a in kp.items()}))
    port = port_cls(**NARROW)
    port.load_state_dict(to_port(jax.tree.map(np.asarray, v)))
    return jm, calibrate(port, seed + 1, 128), port


@pytest.fixture(scope="module")
def emotion_k():
    return _build(JEmotionK, EmotionK, convert.emotion_k_state_dict, 10)


@pytest.fixture(scope="module")
def emotion_map():
    return _build(JEmotionMap, EmotionMap, convert.emotion_map_state_dict, 20)


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
    ref, ref_fake = jm.apply(v, *_jax_args(x, kp), head=head)
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
    ref_feat = jm.apply(v, jx, method=JEmotionK.feature)
    ref, ref_fake = jm.apply(v, ref_feat, jv, jj,
                             method=JEmotionK.emotion_feature)
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


@pytest.mark.parametrize("head", ["map", "map_4"])
def test_emotion_map_heads_match_jax(emotion_map, head):
    """Both keypoint heads go through the keypoint-expectation op (its
    plain version here), at K = 10 and K = 4 on the 58x58 maps."""
    jm, v, port = emotion_map
    x, kp = _inputs(21)
    ref, ref_fake = jm.apply(v, *_jax_args(x, kp), head=head)
    with torch.no_grad():
        ours, fake = port(*_port_args(x, kp), head=head)
    assert ours["jacobian"].shape == (2, 10 if head == "map" else 4, 2, 2)
    _close(fake, ref_fake)
    _close(ours["value"], ref["value"])
    _close(ours["jacobian"], ref["jacobian"])


class _TEmotionKAllHeads(TEmotionK):
    """The torch oracle with the made-coherent ``fc_single`` head and the
    reference's ``final_4`` stack, so every converter branch runs."""

    def __init__(self):
        super().__init__(be=8, max_f=32, blocks=3)
        self.fc_single = tnn.Sequential(tnn.Linear(512, 256), tnn.ReLU(True),
                                        tnn.Linear(256, 64), tnn.ReLU(True))
        self.final_4 = tnn.Sequential(
            tnn.Conv1d(4, 4, 3, 1, 1), tnn.MaxPool1d(2, stride=2),
            tnn.ReLU(True), tnn.Conv1d(4, 4, 3))


@pytest.mark.parametrize("kind", ["emotion_k", "emotion_map"])
def test_emotion_state_dict_round_trip(kind):
    """Reference state_dict -> eamm_tpu.compat -> convert gives back every
    key and value bit for bit, and it loads into the port's model (which
    has no ``final_4``: no head builds it)."""
    torch.manual_seed(5)
    if kind == "emotion_k":
        oracle, to_jax = _TEmotionKAllHeads(), convert_emotion_k
        from_jax, port = convert.emotion_k_state_dict, EmotionK(**NARROW)
    else:
        oracle, to_jax = TEmotionMap(be=8, max_f=32, blocks=3), \
            convert_emotion_map
        from_jax, port = convert.emotion_map_state_dict, EmotionMap(**NARROW)
    _randomize_bn_stats(oracle)
    sd = oracle.state_dict()
    back = from_jax(to_jax({k: v.numpy() for k, v in sd.items()}))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k
    result = port.load_state_dict(back, strict=False)
    assert result.missing_keys == []
    assert all(k.startswith("final_4.") for k in result.unexpected_keys)


def test_build_emotion_detector():
    config = {"model_params": {"emotion_params": NARROW}}
    linear = cfg.build_emotion_detector(config, "linear")
    assert isinstance(linear, EmotionK)
    assert linear.predictor.out_features == 8 + 3
    assert isinstance(cfg.build_emotion_detector(config, "map"), EmotionMap)
    full = cfg.build_emotion_detector(None)
    assert len(full.predictor.encoder.down_blocks) == 5
    assert full.predictor.out_features == 32 + 3


@pytest.mark.parametrize("shape", [(32, 4, 2), (32, 4, 2, 2)])
def test_emotion_one_euro_matches_jax(shape):
    """mincutoff 1, beta 0.2, freq 100, scale 100: beta multiplies the
    scaled derivative, so the scale changes the cutoff."""
    x = (0.05 * np.random.RandomState(3).randn(*shape)).astype(np.float32)
    kw = dict(mincutoff=1.0, beta=0.2, freq=100, scale=100.0)
    ref = jax_one_euro_filter(jnp.asarray(x), **kw)
    ours = one_euro_filter(torch.from_numpy(x), **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-5)
