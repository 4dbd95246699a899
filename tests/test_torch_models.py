"""eamm_tpu_torch models against the eamm_tpu modules at narrow widths: the
port's module is drawn from a seed (torch's default initialization), its
weights go to JAX through ``eamm_tpu.compat``'s converters of the
reference checkpoints (JAX's own init compiled an init program per
module, most of this file's time on the CPU), the JAX variables (their
BatchNorm statistics randomized) come back into the port through
``convert.state_dicts_from_jax``, and both run on the same numpy inputs.
Tolerance 1e-3, the per-module bound the JAX package meets against its
torch oracles (PARITY.md)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eamm_tpu import compat
from eamm_tpu.models import (ATNet as JATNet, KPDetector as JKPDetector,
                             KPDetectorA as JKPDetectorA,
                             OcclusionAwareGenerator as JGenerator)
from eamm_tpu_torch import convert
from eamm_tpu_torch.models import (ATNet, KPDetector, KPDetectorA,
                                   OcclusionAwareGenerator)

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once, and a torch per worker spinning a thread per core
    slows every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-3
DM = dict(block_expansion=8, max_features=32, num_blocks=3, scale_factor=0.25)
GEN = dict(block_expansion=8, max_features=32, num_down_blocks=2,
           num_bottleneck_blocks=1, estimate_occlusion_map=True,
           dense_motion_params=DM)


def _jit(fn, **static):
    """``fn`` with ``static`` bound, compiled as one XLA program: a flax
    ``init`` or ``apply`` run eagerly dispatches (and compiles) each of
    its hundreds of ops on its own, several times slower on the CPU."""
    return jax.jit(functools.partial(fn, **static))


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


def _drawn(port_cls, seed: int, **kwargs):
    """The port's module drawn from ``seed`` (torch's default
    initialization), in eval mode."""
    torch.manual_seed(seed)
    return port_cls(**kwargs).eval()


def _from_port(port, to_jax) -> dict:
    """``port``'s weights as JAX variables, by the compat converter
    ``to_jax`` of the reference checkpoints."""
    return _np_tree(to_jax({k: v.detach().numpy()
                            for k, v in port.state_dict().items()}))


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
    port = _drawn(KPDetector, 0, num_kp=10, block_expansion=8,
                  max_features=32, num_blocks=3)
    v = _perturb_heads(_randomize_stats(
        _from_port(port, compat.convert_kp_detector), 1), rng)
    ref = _jit(jm.apply)(v, jnp.asarray(img))
    port.load_state_dict(convert.kp_detector_state_dict(v))
    with torch.no_grad():
        ours = port(_nchw(img))
    _close(ours["value"], ref["value"])
    _close(ours["jacobian"], ref["jacobian"])


def test_kp_detector_a():
    rng = np.random.RandomState(1)
    jm = JKPDetectorA(num_kp=10, temperature=0.1)
    fmap = rng.randn(3, 64, 64, 35).astype(np.float32)
    port = _drawn(KPDetectorA, 1)
    v = _perturb_heads(_from_port(port, compat.convert_kp_detector_a), rng)
    ref = _jit(jm.apply)(v, jnp.asarray(fmap))
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
    port = _drawn(OcclusionAwareGenerator, 2, **GEN)
    v = _randomize_stats(_from_port(port, compat.convert_generator), 3)
    port.load_state_dict(convert.generator_state_dict(v))
    return jm, v, port, src


def test_dense_motion(generators):
    """Shared source: one source image, three keypoint sets."""
    jm, v, port, src = generators
    rng = np.random.RandomState(4)
    kp_d, kp_s = _kp(rng, 3), _kp(rng, 3)
    ref = _jit(jm.apply, method=lambda m, s, d, k: m.dense_motion_network(
        s, kp_driving=d, kp_source=k, shared_source=True))(
        v, jnp.asarray(src), _j(kp_d), _j(kp_s))
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
    feats = _jit(jm.apply, method=jm.encode_source)(v, jnp.asarray(src))
    ref = _jit(jm.apply, method=jm.decode, want_aux=False,
               shared_source=True)(v, jnp.asarray(src), feats, _j(kp_d),
                                   _j(kp_s))
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
    port = _drawn(ATNet, 3)
    v = _randomize_stats(_from_port(port, compat.convert_atnet), 7)
    ref = _jit(jm.apply, audio_weight=1.6)(
        v, jnp.asarray(img), jnp.asarray(audio),
        jnp.asarray(pose))                                # [B,T,64,64,35]
    port.load_state_dict(convert.atnet_state_dict(v))
    with torch.no_grad():
        ours = port(_nchw(img), torch.from_numpy(audio),
                    torch.from_numpy(pose), audio_weight=1.6)
    _close(ours.permute(0, 1, 3, 4, 2), ref)
