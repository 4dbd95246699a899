"""The port's StyleGAN2 (``eamm_tpu_torch/models/stylegan2.py``) against
the JAX package's on the same numpy inputs, on the CPU.

Bounds: the ops (``upfirdn2d`` up and down, ``fused_leaky_relu``) within
1e-5; each network within 1e-3 (PARITY.md's bound for a network against
its reference).  The synthesis network's weights go from the port to JAX
through ``eamm_tpu.compat.convert_stylegan2``, and ``convert.
synthesis_state_dict`` must give them back bit for bit; the image
networks, which no converter reads, are initialized by flax (jitted) and
carried to the port by ``state_dicts_from_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eamm_tpu.compat import convert_stylegan2
from eamm_tpu.models import stylegan2 as jsg
from eamm_tpu_torch import convert
from eamm_tpu_torch.models import stylegan2 as sg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once, and a torch per worker spinning a thread per core
    slows every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(ours: torch.Tensor, ref, atol: float) -> None:
    ref = np.asarray(ref)
    ours = ours.detach().numpy()
    if ours.ndim == 4:
        ours = ours.transpose(0, 2, 3, 1)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("case", ["up2", "down2", "plain", "leaky_relu"])
def test_ops_match_jax(case):
    """upfirdn2d with the synthesis network's skip upsampling (up 2, pads
    (2, 1)), the discriminator's blur-and-stride (down 2, pads (2, 2)), a
    plain FIR, and the fused bias + leaky ReLU: within 1e-5."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 7, 5).astype(np.float32)
    if case == "leaky_relu":
        bias = rng.randn(5).astype(np.float32)
        _close(sg.fused_leaky_relu(_nchw(x), torch.from_numpy(bias)),
               jsg.fused_leaky_relu(jnp.asarray(x), jnp.asarray(bias)), 1e-5)
        return
    up, down, pad = {"up2": (2, 1, (2, 1)), "down2": (1, 2, (2, 2)),
                     "plain": (1, 1, (1, 2))}[case]
    kernel = sg.fir_kernel((1, 3, 3, 1)) * (4.0 if up > 1 else 1.0)
    kernel[0, 1] += 0.25                  # asymmetric: a flip would show
    _close(sg.upfirdn2d(_nchw(x), kernel, up, down, pad),
           jsg.upfirdn2d(jnp.asarray(x), kernel, up, down, pad), 1e-5)


def test_synthesis_matches_jax_and_converts_back():
    """The synthesis network at the gan ATNet's configuration (size 64,
    style 256, 8 MLP layers, 35 channels) with seeded weights: its
    state_dict through convert_stylegan2 and back is itself bit for bit,
    and the JAX network on the converted weights gives its output within
    1e-3."""
    port = sg.SynthesisGenerator(size=64, style_dim=256, n_mlp=8,
                                 out_channels=35).eval()
    gen = torch.Generator().manual_seed(0)
    sg.draw_parameters(port, gen)
    with torch.no_grad():                 # biases the initialization zeroes
        for name, p in port.named_parameters():
            if name.endswith("bias") and "style" not in name:
                p.uniform_(-0.2, 0.2, generator=gen)
    sd = port.state_dict()
    params = convert_stylegan2({k: v.numpy() for k, v in sd.items()})
    back = convert.synthesis_state_dict({"params": params})
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert back[k].shape == v.shape and torch.equal(back[k], v), k
    style = np.random.RandomState(1).randn(3, 256).astype(np.float32)
    with torch.no_grad():
        ours = port(torch.from_numpy(style))
    ref = jax.jit(jsg.SynthesisGenerator(size=64).apply)(
        {"params": params}, jnp.asarray(style))
    _close(ours, ref, 1e-3)


# name in state_dicts_from_jax -> (JAX module, port module, input NHWC,
# call keyword arguments)
IMAGE_NETWORKS = {
    "stylegan2_discriminator": (
        lambda: jsg.StyleGAN2Discriminator(size=16, ndf=4),
        lambda: sg.StyleGAN2Discriminator(size=16, ndf=4), (2, 16, 16, 3),
        {}),
    "tile_stylegan2_discriminator": (
        lambda: jsg.TileStyleGAN2Discriminator(patch_size=16, ndf=4,
                                               variant="patch"),
        lambda: sg.TileStyleGAN2Discriminator(patch_size=16, ndf=4,
                                              variant="patch"),
        (1, 32, 32, 3), {}),
    "stylegan2_encoder": (
        lambda: jsg.StyleGAN2Encoder(size=16, ngf=4, n_blocks=2),
        lambda: sg.StyleGAN2Encoder(size=16, ngf=4, n_blocks=2),
        (2, 16, 16, 3), {"layers": (0, 1, 2, -1), "get_features": True}),
    "stylegan2_image_generator": (
        lambda: jsg.StyleGAN2ImageGenerator(size=16, ngf=4, n_blocks=2),
        lambda: sg.StyleGAN2ImageGenerator(size=16, ngf=4, n_blocks=2),
        (2, 16, 16, 3), {"layers": (1, -1)}),
}


def _flat(out):
    """A network's output as a list of tensors or arrays."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


@pytest.mark.parametrize("name", list(IMAGE_NETWORKS))
def test_image_networks_match_jax(name):
    """Discriminator (global head), the tiled one (patch head), the
    encoder with its feature taps (the input, from-RGB, the downsampling
    block, the last) and the image generator (whose decoder upsamples by
    style-free modulated convolutions) on flax-initialized weights with
    biases drawn: every output within 1e-3."""
    jax_module, port_module, shape, kwargs = IMAGE_NETWORKS[name]
    rng = np.random.RandomState(2)
    x = rng.rand(*shape).astype(np.float32)
    model = jax_module()
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree.map(
        lambda a: np.asarray(a) + (rng.uniform(-0.2, 0.2, a.shape)
                                   .astype(np.float32)
                                   if a.ndim == 1 else 0.0), variables)
    ref = jax.jit(lambda v, x: model.apply(v, x, **kwargs))(variables,
                                                           jnp.asarray(x))
    port = port_module().eval()
    port.load_state_dict(convert.state_dicts_from_jax({name: variables})
                         [name])
    with torch.no_grad():
        ours = port(_nchw(x), **kwargs)
    ours, ref = _flat(ours), _flat(ref)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        _close(o, r, 1e-3)
