"""The keypoint heads' other forms and the pipeline's two host helpers
against the JAX package on the CPU: ``estimate_jacobian: false`` (no
``jacobian`` conv, value by ``gaussian2kp``, no Jacobian) in KPDetector,
KPDetectorA and the generator's dense motion, ``single_jacobian_map=True``
(one 4-channel map weighted by each keypoint's heatmap), the builders, and
``EammPipeline.audio_to_windows`` / ``prepare_pose``.  The port's modules
are drawn from seeds, their weights go to JAX through ``eamm_tpu.compat``
and come back through ``convert``, as in tests/test_torch_models.py;
tolerance 1e-3 as there."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eamm_tpu import compat
from eamm_tpu.infer import EammPipeline as JaxPipeline
from eamm_tpu.models import (KPDetector as JKPDetector,
                             KPDetectorA as JKPDetectorA)
from eamm_tpu.models.dense_motion import DenseMotionNetwork as JDenseMotion
from eamm_tpu_torch import config as cfg
from eamm_tpu_torch import convert
from eamm_tpu_torch.infer import EammPipeline
from eamm_tpu_torch.models import (KPDetector, KPDetectorA,
                                   OcclusionAwareGenerator)
from eamm_tpu_torch.models.dense_motion import DenseMotionNetwork
from tests.conftest import TINY_CONFIG
from tests.test_torch_models import (DM, GEN, _close, _drawn, _from_port,
                                     _j, _jit, _kp, _nchw, _randomize_stats,
                                     _t)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _heads_weights(v, rng):
    """Random Jacobian weights, where the head has them (JAX starts them
    at zero: the identity everywhere)."""
    head = v["params"]["head"]
    if "jacobian" in head:
        k = head["jacobian"]["kernel"]
        head["jacobian"]["kernel"] = (0.01 * rng.randn(*k.shape)
                                      ).astype(np.float32)
    return v


# (detector, estimate_jacobian, single_jacobian_map)
HEADS = [("image", False, False), ("audio", False, False),
         ("audio", True, True)]


@pytest.mark.parametrize("head", HEADS, ids=lambda h: "-".join(map(str, h)))
def test_detector_heads_match_jax(head):
    kind, estimate, single = head
    rng = np.random.RandomState(10)
    opts = dict(estimate_jacobian=estimate, single_jacobian_map=single)
    if kind == "image":
        jm = JKPDetector(num_kp=10, block_expansion=8, max_features=32,
                         num_blocks=3, temperature=0.1, scale_factor=0.25,
                         **opts)
        port = _drawn(KPDetector, 0, num_kp=10, block_expansion=8,
                      max_features=32, num_blocks=3, **opts)
        x = rng.rand(2, 64, 64, 3).astype(np.float32)
        to_jax, to_sd = (compat.convert_kp_detector,
                         convert.kp_detector_state_dict)
    else:
        jm = JKPDetectorA(num_kp=10, temperature=0.1, **opts)
        port = _drawn(KPDetectorA, 0, **opts)
        x = rng.randn(2, 64, 64, 35).astype(np.float32)
        to_jax, to_sd = (compat.convert_kp_detector_a,
                         convert.kp_detector_a_state_dict)
    v = _from_port(port, to_jax)
    if kind == "image":
        v = _randomize_stats(v, 1)
    v = _heads_weights(v, rng)
    ref = _jit(jm.apply)(v, jnp.asarray(x))
    port.load_state_dict(to_sd(v))          # strict: no stray jacobian
    with torch.no_grad():
        ours = port.eval()(_nchw(x))
    _close(ours["value"], ref["value"])
    assert ("jacobian" in ours) == estimate
    assert (port.jacobian is None) == (not estimate)
    if estimate:
        assert port.jacobian.out_channels == (4 if single else 40)
        _close(ours["jacobian"], ref["jacobian"])
    port.reset_jacobian()                   # a no-op without the conv


def test_dense_motion_without_jacobians_matches_jax():
    """The generator's dense motion reads ``kp.get('jacobian')``:
    keypoints without one move the source by their translation alone, as
    in JAX (whose generator holds no Jacobian parameters either way)."""
    rng = np.random.RandomState(11)
    jm = JDenseMotion(num_kp=10, **DM)
    src = rng.rand(1, 64, 64, 3).astype(np.float32)
    kp_d = {"value": _kp(rng, 3)["value"]}
    kp_s = {"value": _kp(rng, 3)["value"]}
    args = (jnp.asarray(src), _j(kp_d), _j(kp_s))
    gen = _from_port(_drawn(OcclusionAwareGenerator, 2, **GEN),
                     compat.convert_generator)
    v = _randomize_stats({k: gen[k]["dense_motion_network"]
                          for k in ("params", "batch_stats")}, 3)
    ref = _jit(jm.apply, shared_source=True)(v, *args)
    port = DenseMotionNetwork(num_kp=10, **DM).eval()
    port.load_state_dict(convert.dense_motion_state_dict(v))
    with torch.no_grad():
        ours = port(_nchw(src), _t(kp_d), _t(kp_s))
    _close(ours["deformation"], ref["deformation"])
    _close(ours["mask"].permute(0, 2, 3, 1), ref["mask"])


def test_builders_take_estimate_jacobian():
    """The flag passes through the builders instead of being refused."""
    config = {**TINY_CONFIG, "model_params": {
        **TINY_CONFIG["model_params"],
        "common_params": {**TINY_CONFIG["model_params"]["common_params"],
                          "estimate_jacobian": False},
        "audio_params": {**TINY_CONFIG["model_params"]["audio_params"],
                         "estimate_jacobian": False}}}
    assert cfg.build_kp_detector(config).jacobian is None
    assert cfg.build_kp_detector_a(config).jacobian is None
    assert isinstance(cfg.build_generator(config), OcclusionAwareGenerator)
    assert cfg.build_kp_detector(TINY_CONFIG).jacobian is not None


def test_audio_to_windows_and_prepare_pose_match_jax():
    """JAX's signatures and results: numpy in, the same shapes out."""
    rng = np.random.RandomState(12)
    wav = (0.1 * rng.randn(9000)).astype(np.float32)
    ref = JaxPipeline.audio_to_windows(None, wav)
    ours = EammPipeline.audio_to_windows(
        types.SimpleNamespace(device=torch.device("cpu")), wav)
    assert isinstance(ours, np.ndarray) and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)
    for smooth in (True, False):
        owner = types.SimpleNamespace(
            options=types.SimpleNamespace(smooth_pose=smooth))
        for pose, T in ((rng.randn(30, 7), 75), (rng.randn(1, 7), 20)):
            want = JaxPipeline.prepare_pose(owner, pose.astype(np.float32), T)
            got = EammPipeline.prepare_pose(owner, pose.astype(np.float32), T)
            assert got.shape == want.shape == (T, 6)
            np.testing.assert_allclose(got, want, atol=1e-6)
