"""convert.state_dicts_from_jax is the exact inverse of the JAX package's
torch converters: torch oracle state_dict -> eamm_tpu.compat.convert_* ->
state_dicts_from_jax gives back every key and every value, bit for bit,
and the result loads into the port's modules."""
import numpy as np
import pytest
import torch

from eamm_tpu.compat import (convert_atnet, convert_emotion_k,
                             convert_emotion_map, convert_generator,
                             convert_kp_detector, convert_kp_detector_a)
from eamm_tpu_torch import convert
from eamm_tpu_torch.models import (ATNet, KPDetector, KPDetectorA,
                                   OcclusionAwareGenerator)
from tests.test_compat_generator import TGenerator
from tests.test_compat_emotion import TEmotionK
from tests.test_compat_emotion_map import TEmotionMap
from tests.test_compat_parity import (TATNet, TKPDetector, TKPDetectorA,
                                      _randomize_bn_stats)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once, and a torch per worker spinning a thread per core
    slows every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _oracle_kp():
    return (TKPDetector(be=8, max_f=32, num_blocks=3), convert_kp_detector,
            convert.kp_detector_state_dict,
            lambda: KPDetector(block_expansion=8, max_features=32,
                               num_blocks=3))


def _oracle_kp_a():
    return (TKPDetectorA(), convert_kp_detector_a,
            convert.kp_detector_a_state_dict, KPDetectorA)


def _oracle_generator():
    gen = TGenerator(be=8, max_f=32, bottleneck=2)
    return (gen,
            lambda sd: convert_generator(sd, num_down_blocks=2,
                                         num_bottleneck_blocks=2,
                                         dense_num_blocks=5),
            convert.generator_state_dict,
            lambda: OcclusionAwareGenerator(
                block_expansion=8, max_features=32, num_down_blocks=2,
                num_bottleneck_blocks=2,
                dense_motion_params=dict(block_expansion=64, max_features=256,
                                         num_blocks=5)))


def _oracle_atnet():
    return TATNet(), convert_atnet, convert.atnet_state_dict, ATNet


@pytest.mark.parametrize("make", [_oracle_kp, _oracle_kp_a, _oracle_generator,
                                  _oracle_atnet],
                         ids=["kp_detector", "kp_detector_a", "generator",
                              "audio_feature"])
def test_round_trip(make):
    torch.manual_seed(0)
    oracle, to_jax, from_jax, port = make()
    _randomize_bn_stats(oracle)
    sd = oracle.state_dict()
    back = from_jax(to_jax({k: v.numpy() for k, v in sd.items()}))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k
    port().load_state_dict(back)          # strict: names and shapes fit


def test_state_dicts_from_jax_covers_the_four_models():
    """The four models of the neutral render, and the emotion model of
    each ``emo_type``."""
    torch.manual_seed(1)
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    variables = {
        "kp_detector": convert_kp_detector(sd(TKPDetector(be=8, max_f=32,
                                                          num_blocks=3))),
        "kp_detector_a": convert_kp_detector_a(sd(TKPDetectorA())),
        "audio_feature": convert_atnet(sd(TATNet())),
        "generator": convert_generator(sd(TGenerator(be=8, max_f=32,
                                                     bottleneck=1)),
                                       num_down_blocks=2,
                                       num_bottleneck_blocks=1,
                                       dense_num_blocks=5),
    }
    emotion = {
        "linear_3": convert_emotion_k(sd(TEmotionK(be=8, max_f=32, blocks=3))),
        "map": convert_emotion_map(sd(TEmotionMap(be=8, max_f=32, blocks=3))),
    }
    for emo_type, emo in emotion.items():
        out = convert.state_dicts_from_jax({**variables, "emo_detector": emo},
                                           emo_type)
        assert sorted(out) == ["audio_feature", "emo_detector", "generator",
                               "kp_detector", "kp_detector_a"]
        assert ("kp_4.weight" in out["emo_detector"]) == (emo_type == "map")
        assert all(isinstance(v, torch.Tensor) for sd_ in out.values()
                   for v in sd_.values())
    assert np.array_equal(out["kp_detector_a"]["kp.weight"].numpy(),
                          variables["kp_detector_a"]["params"]["head"]["kp"]
                          ["kernel"].transpose(3, 2, 0, 1))
