"""eamm_tpu_torch models against the eamm_tpu modules at narrow widths: the
JAX module is initialised, its variables go through
``convert.state_dicts_from_jax`` into the port, and both run on the same
numpy inputs.  Tolerance 1e-3, the per-module bound the JAX package meets
against its torch oracles (PARITY.md)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eamm_tpu.models import (ATNet as JATNet, KPDetector as JKPDetector,
                             KPDetectorA as JKPDetectorA,
                             OcclusionAwareGenerator as JGenerator)
from eamm_tpu_torch import convert
from eamm_tpu_torch.models import (ATNet, KPDetector, KPDetectorA,
                                   OcclusionAwareGenerator)

TOL = 1e-3
DM = dict(block_expansion=8, max_features=32, num_blocks=3, scale_factor=0.25)
GEN = dict(block_expansion=8, max_features=32, num_down_blocks=2,
           num_bottleneck_blocks=1, estimate_occlusion_map=True,
           dense_motion_params=DM)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _randomize_stats(variables, seed):
    """Non-trivial BN running statistics, so eval BN is really tested."""
    rng = np.random.RandomState(seed)
    stats = jax.tree.map(
        lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
        _np_tree(variables["batch_stats"]))
    return {"params": _np_tree(variables["params"]), "batch_stats": stats}


def _close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def _kp(rng, B, K=10):
    return {"value": rng.uniform(-0.8, 0.8, (B, K, 2)).astype(np.float32),
            "jacobian": (np.tile(np.eye(2, dtype=np.float32), (B, K, 1, 1))
                         + 0.1 * rng.randn(B, K, 2, 2).astype(np.float32))}


def _j(kp):
    return {k: jnp.asarray(v) for k, v in kp.items()}


def _t(kp):
    return {k: torch.from_numpy(v) for k, v in kp.items()}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _perturb_heads(variables, rng):
    """JAX initialises the Jacobian heads to zero weight; give them weights
    so the expectation of the Jacobian maps is really tested."""
    head = variables["params"]["head"]["jacobian"]
    head["kernel"] = (0.01 * rng.randn(*head["kernel"].shape)).astype(np.float32)
    return variables


def test_kp_detector():
    rng = np.random.RandomState(0)
    jm = JKPDetector(num_kp=10, block_expansion=8, max_features=32,
                     num_blocks=3, temperature=0.1, scale_factor=0.25)
    img = rng.rand(2, 128, 128, 3).astype(np.float32)
    v = _perturb_heads(_randomize_stats(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(img[:1])), 1), rng)
    ref = jm.apply(v, jnp.asarray(img))
    port = KPDetector(num_kp=10, block_expansion=8, max_features=32,
                      num_blocks=3).eval()
    port.load_state_dict(convert.kp_detector_state_dict(v))
    with torch.no_grad():
        ours = port(_nchw(img))
    _close(ours["value"], ref["value"])
    _close(ours["jacobian"], ref["jacobian"])


def test_kp_detector_a():
    rng = np.random.RandomState(1)
    jm = JKPDetectorA(num_kp=10, temperature=0.1)
    fmap = rng.randn(3, 64, 64, 35).astype(np.float32)
    v = _perturb_heads(_np_tree(jm.init(jax.random.PRNGKey(1),
                                        jnp.asarray(fmap[:1]))), rng)
    ref = jm.apply(v, jnp.asarray(fmap))
    port = KPDetectorA().eval()
    port.load_state_dict(convert.kp_detector_a_state_dict(v))
    with torch.no_grad():
        ours = port(_nchw(fmap))
    _close(ours["value"], ref["value"])
    _close(ours["jacobian"], ref["jacobian"])


@pytest.fixture(scope="module")
def generators():
    rng = np.random.RandomState(2)
    jm = JGenerator(**GEN)
    src = rng.rand(1, 64, 64, 3).astype(np.float32)
    kp0 = _j(_kp(rng, 1))
    v = _randomize_stats(jm.init(jax.random.PRNGKey(2), jnp.asarray(src),
                                 kp0, kp0), 3)
    port = OcclusionAwareGenerator(**GEN).eval()
    port.load_state_dict(convert.generator_state_dict(v))
    return jm, v, port, src


def test_dense_motion(generators):
    """Shared source: one source image, three keypoint sets."""
    jm, v, port, src = generators
    rng = np.random.RandomState(4)
    kp_d, kp_s = _kp(rng, 3), _kp(rng, 3)
    ref = jm.apply(v, jnp.asarray(src), _j(kp_d), _j(kp_s),
                   method=lambda m, s, d, k: m.dense_motion_network(
                       s, kp_driving=d, kp_source=k, shared_source=True))
    with torch.no_grad():
        ours = port.dense_motion_network(_nchw(src), _t(kp_d), _t(kp_s))
    _close(ours["deformation"], ref["deformation"])
    _close(ours["sparse_deformed"], ref["sparse_deformed"])
    _close(ours["mask"].permute(0, 2, 3, 1), ref["mask"])
    _close(ours["occlusion_map"].permute(0, 2, 3, 1), ref["occlusion_map"])


def test_generator_encode_decode(generators):
    jm, v, port, src = generators
    rng = np.random.RandomState(5)
    kp_d, kp_s = _kp(rng, 3), _kp(rng, 3)
    feats = jm.apply(v, jnp.asarray(src), method=jm.encode_source)
    ref = jm.apply(v, jnp.asarray(src), feats, _j(kp_d), _j(kp_s),
                   method=jm.decode, want_aux=False, shared_source=True)
    with torch.no_grad():
        ours_feats = port.encode_source(_nchw(src))
        ours = port.decode(_nchw(src), ours_feats, _t(kp_d), _t(kp_s))
    _close(ours_feats.permute(0, 2, 3, 1), feats)
    _close(ours.permute(0, 2, 3, 1), ref["prediction"])


def test_atnet():
    rng = np.random.RandomState(6)
    jm = JATNet(jaco_net="cnn")
    img = rng.rand(1, 256, 256, 3).astype(np.float32)
    audio = rng.randn(1, 3, 28, 12).astype(np.float32)
    pose = rng.randn(1, 3, 6).astype(np.float32)
    v = _randomize_stats(jm.init(jax.random.PRNGKey(3), jnp.asarray(img),
                                 jnp.asarray(audio[:, :1]),
                                 jnp.asarray(pose[:, :1])), 7)
    ref = jm.apply(v, jnp.asarray(img), jnp.asarray(audio), jnp.asarray(pose),
                   audio_weight=1.6)                      # [B,T,64,64,35]
    port = ATNet().eval()
    port.load_state_dict(convert.atnet_state_dict(v))
    with torch.no_grad():
        ours = port(_nchw(img), torch.from_numpy(audio),
                    torch.from_numpy(pose), audio_weight=1.6)
    _close(ours.permute(0, 1, 3, 4, 2), ref)
