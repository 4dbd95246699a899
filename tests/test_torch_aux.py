"""The port's auxiliary networks (``models/aux.py``) and AdaIN helpers
(``ops/adain.py``) against the JAX package's, on the CPU.

Bounds: the AdaIN ops within 1e-5, each network within 1e-3 (PARITY.md).
Where ``eamm_tpu.compat`` converts a network from the reference's names,
the port's seeded weights (BatchNorm statistics drawn too) go to JAX
through that converter, and ``convert.state_dicts_from_jax`` must give
the port's state_dict back bit for bit; TFNet's AdaIN modes, which no
converter reads, are initialized by flax (jitted) and carried over.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eamm_tpu import compat
from eamm_tpu.models import aux as jaux
from eamm_tpu.ops import adain as jadain
from eamm_tpu_torch.convert import state_dicts_from_jax
from eamm_tpu_torch.infer.pipeline import reset_parameters
from eamm_tpu_torch.models import aux
from eamm_tpu_torch.ops import adain


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once, and a torch per worker spinning a thread per core
    slows every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor (other ranks as they are)."""
    if x.ndim == 4 and x.shape[-1] in (1, 3):
        x = x.transpose(0, 3, 1, 2)
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(ours, ref, atol: float) -> None:
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    if ours.ndim >= 4 and ours.shape != ref.shape:       # channels last
        ours = np.moveaxis(ours, -3, -1)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


def test_adain_ops_match_jax():
    """calc_mean_std, adaptive_instance_normalization and coral within
    1e-5."""
    rng = np.random.RandomState(0)
    content = rng.randn(2, 6, 5, 4).astype(np.float32)
    style = (2.0 * rng.randn(2, 6, 5, 4) + 1.0).astype(np.float32)
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
    mean, std = adain.calc_mean_std(nchw(content))
    ref_mean, ref_std = jadain.calc_mean_std(jnp.asarray(content))
    _close(mean, ref_mean, 1e-5)
    _close(std, ref_std, 1e-5)
    _close(adain.adaptive_instance_normalization(nchw(content), nchw(style)),
           jadain.adaptive_instance_normalization(jnp.asarray(content),
                                                  jnp.asarray(style)), 1e-5)
    src = rng.rand(16, 12, 3).astype(np.float32)
    tgt = (0.5 * rng.rand(16, 12, 3) ** 2 + 0.2).astype(np.float32)
    _close(adain.coral(torch.from_numpy(src), torch.from_numpy(tgt)),
           jadain.coral(jnp.asarray(src), jnp.asarray(tgt)), 1e-5)


def _seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    reset_parameters(module, torch.Generator().manual_seed(seed))
    return module.eval()


def _mfcc(rng):
    return rng.randn(2, 28, 12).astype(np.float32)


# group -> [(state_dicts_from_jax name, port module, JAX module, JAX
# converter, inputs)]
CONVERTED = {
    "audio_encoders": [
        ("ct_encoder", aux.CtEncoder, jaux.CtEncoder,
         compat.convert_ct_encoder, lambda r: (_mfcc(r),)),
        ("emotion_net", aux.EmotionNet, jaux.EmotionNet,
         compat.convert_emotion_net, lambda r: (_mfcc(r),)),
        ("a2i", aux.A2I, jaux.A2I, compat.convert_a2i,
         lambda r: (_mfcc(r),)),
        ("audio_feature_composite", aux.AudioFeature, jaux.AudioFeature,
         compat.convert_audio_feature, lambda r: (_mfcc(r),))],
    "decoders": [
        ("af2f", aux.AF2F, jaux.AF2F, compat.convert_af2f,
         lambda r: (r.randn(2, 256).astype(np.float32),
                    r.randn(2, 128).astype(np.float32))),
        ("af2f_s", aux.AF2FS, jaux.AF2FS, compat.convert_af2f_s,
         lambda r: (r.randn(2, 256).astype(np.float32),)),
        ("na_net", aux.NANet, jaux.NANet, compat.convert_na_net,
         lambda r: (r.randn(2, 6, 5).astype(np.float32),))],
    "em_detector": [
        ("em_detector", lambda: aux.EmDetector(8, 3, 32, 3),
         lambda: jaux.EmDetector(block_expansion=8, max_features=32,
                                 num_blocks=3),
         compat.convert_em_detector,
         lambda r: (r.rand(2, 64, 64, 3).astype(np.float32),))],
    "tf_net_concat": [
        ("tf_net", aux.TFNet, jaux.TFNet, compat.convert_tfnet,
         lambda r: (r.rand(1, 256, 256, 3).astype(np.float32),
                    r.randn(1, 3, 28, 12).astype(np.float32),
                    r.randn(1, 3, 6).astype(np.float32),
                    r.randn(1, 3, 512).astype(np.float32)))],
}


@pytest.mark.parametrize("group", list(CONVERTED))
def test_converted_networks_match_jax(group):
    """Each network the JAX package converts from the reference's names,
    on seeded port weights: the converter's tree back through
    state_dicts_from_jax is the port's state_dict bit for bit, and the JAX
    network on that tree gives the port's outputs within 1e-3."""
    for i, (name, port_cls, jax_cls, to_jax, inputs) in enumerate(
            CONVERTED[group]):
        port = _seeded(port_cls(), i)
        sd = port.state_dict()
        variables = to_jax({k: v.numpy() for k, v in sd.items()})
        back = state_dicts_from_jax({name: variables})[name]
        sd = {k: v for k, v in sd.items()
              if not k.endswith("num_batches_tracked")}
        back = {k: v for k, v in back.items()
                if not k.endswith("num_batches_tracked")}
        assert back.keys() == sd.keys(), name
        for k, v in sd.items():
            assert torch.equal(back[k], v), (name, k)
        args = inputs(np.random.RandomState(i))
        ref = jax.jit(jax_cls().apply)(variables, *map(jnp.asarray, args))
        with torch.no_grad():
            ours = port(*map(_t, args))
        for o, r in zip(ours if isinstance(ours, tuple) else (ours,),
                        ref if isinstance(ref, tuple) else (ref,)):
            _close(o, r, 1e-3)


def test_tfnet_adain_modes_match_jax():
    """TFNet 'adain_input' and 'adain_output' (the JAX package's redesign,
    which no converter reads; the port's own names for the style layers)
    on seeded port weights: the JAX tree built from them (the trunk
    through convert_tfnet, the style layers transposed) converts back bit
    for bit, and the JAX network on it gives the port's output within
    1e-3."""
    rng = np.random.RandomState(5)
    args = (rng.rand(1, 256, 256, 3).astype(np.float32),
            rng.randn(1, 3, 28, 12).astype(np.float32),
            rng.randn(1, 3, 6).astype(np.float32),
            rng.randn(1, 3, 512).astype(np.float32))
    for seed, (mode, layer, jax_name) in enumerate(
            (("adain_input", "input_style", "style_mod"),
             ("adain_output", "output_style", "style_mod1"))):
        port = _seeded(aux.TFNet(mode), seed)
        sd = {k: v.numpy() for k, v in port.state_dict().items()}
        variables = compat.convert_tfnet(
            {k.replace("lstm.", "lstm_two."): v for k, v in sd.items()})
        params = variables["params"]
        params["lstm"] = params.pop("lstm_two")
        params[jax_name] = {"kernel": sd[f"{layer}.weight"].T,
                            "bias": sd[f"{layer}.bias"]}
        back = state_dicts_from_jax({"tf_net": variables})["tf_net"]
        for k, v in port.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(back[k], v), (mode, k)
        ref = jax.jit(jaux.TFNet(mode=mode).apply)(variables,
                                                   *map(jnp.asarray, args))
        with torch.no_grad():
            ours = port(*map(_t, args))
        _close(ours, ref, 1e-3)
