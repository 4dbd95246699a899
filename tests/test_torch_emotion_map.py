"""The port's EmotionMap against eamm_tpu's, drawn and calibrated as
tests/test_torch_emotion.py draws EmotionK (within 1e-3); both emotion
converters as the exact inverse of ``eamm_tpu.compat``'s; the detector's
builder; the emotion one-euro filter (scale 100) against the JAX filter."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from eamm_tpu.compat import convert_emotion_k, convert_emotion_map
from eamm_tpu.models import EmotionMap as JEmotionMap
from eamm_tpu.ops.filters import one_euro_filter as jax_one_euro_filter
from eamm_tpu_torch import config as cfg
from eamm_tpu_torch import convert
from eamm_tpu_torch.models import EmotionK, EmotionMap
from eamm_tpu_torch.ops.filters import one_euro_filter
from tests.test_compat_emotion import TEmotionK
from tests.test_compat_emotion_map import TEmotionMap
from tests.test_compat_parity import _randomize_bn_stats
from tests.test_torch_emotion import (NARROW, _build, _inputs, _jax_args,
                                      _port_args, one_thread)  # noqa: F401
from tests.test_torch_models import _close, _jit


@pytest.fixture(scope="module")
def emotion_map():
    return _build(JEmotionMap, EmotionMap, convert.emotion_map_state_dict, 20)


@pytest.mark.parametrize("head", ["map", "map_4"])
def test_emotion_map_heads_match_jax(emotion_map, head):
    """Both keypoint heads go through the keypoint-expectation op (its
    plain version here), at K = 10 and K = 4 on the 58x58 maps."""
    jm, v, port = emotion_map
    x, kp = _inputs(21)
    ref, ref_fake = _jit(jm.apply, head=head)(v, *_jax_args(x, kp))
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
