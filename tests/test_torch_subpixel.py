"""The eval-mode convolution forms (``eamm_tpu_torch/ops/subpixel.py``)
against ``eamm_tpu/ops/subpixel.py`` and against the literal convolutions
they rewrite, on the same seeded numpy inputs in float32 (1e-5); an
``UpBlock`` in eval against the JAX module (1e-3, PARITY.md); the models'
eval forms against their literal forms; and the folded weights following a
later ``load_state_dict``.  ``test_torch_models.py`` holds the dense motion
network, the generator and both keypoint detectors in eval, which run these
forms, to the JAX modules."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eamm_tpu.models.blocks import UpBlock as JUpBlock
from eamm_tpu.ops import subpixel as jsub
from eamm_tpu_torch import convert
from eamm_tpu_torch.models import KPDetectorA, OcclusionAwareGenerator
from eamm_tpu_torch.models import kp_detector as kpd
from eamm_tpu_torch.models.blocks import UpBlock
from eamm_tpu_torch.ops import subpixel as tsub
from tests.conftest import TINY_CONFIG

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once, and a torch per worker spinning a thread per core
    slows every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(rng, k, cin, cout):
    """HWIO weights at the torch init's scale, so outputs are O(1)."""
    bound = 1.0 / np.sqrt(k * k * cin)
    return rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32)


def _t(x_nhwc, w_hwio):
    return (torch.from_numpy(x_nhwc).permute(0, 3, 1, 2),
            torch.from_numpy(w_hwio).permute(3, 2, 0, 1))


def _close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def _up(x):
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3)


def _phase_major(w_folded, C):
    """Port fold [C*P, ...] (channel c*P + p) -> JAX order (p*C + c)."""
    P = w_folded.shape[0] // C
    return w_folded.reshape(C, P, *w_folded.shape[1:]).transpose(0, 1)


# form -> (kernel size, its JAX output, the port's, the literal conv,
#          the JAX fold and the port's in JAX's channel order, or None)
FORMS = {
    "d2s": (3, lambda x, w: jsub.upsample_conv3x3_d2s(x, w),
            lambda x, w: tsub.upsample_conv3x3_d2s(x, w),
            lambda x, w: F.conv2d(_up(x), w, padding=1),
            lambda w: jsub.fold_upsample_kernel_d2s(w),
            lambda w, C: _phase_major(tsub.fold_upsample_kernel_d2s(w), C)),
    "folded_2x2": (3, lambda x, w: jsub.upsample_conv3x3_folded(x, w),
                   lambda x, w: tsub.upsample_conv3x3_folded(x, w),
                   lambda x, w: F.conv2d(_up(x), w, padding=1),
                   lambda w: jsub.fold_upsample_kernel(w),
                   lambda w, C: _phase_major(tsub.fold_upsample_kernel(w),
                                             C)),
    "s2d": (7, lambda x, w: jsub.conv_s2d(x, w, block=4),
            lambda x, w: tsub.conv_s2d(x, w, block=4),
            lambda x, w: F.conv2d(x, w, padding=3), None, None),
    "s2d_valid": (7, lambda x, w: jsub.conv_s2d(x, w, block=4, pad=0),
                  lambda x, w: tsub.conv_s2d(x, w, block=4, pad=0),
                  lambda x, w: F.pad(F.conv2d(x, w), (0, 6, 0, 6)), None,
                  None),
    "s2d_strided": (7, lambda x, w: jsub.conv_s2d_strided(x, w, block=4),
                    lambda x, w: tsub.conv_s2d_strided(x, w, block=4),
                    lambda x, w: F.conv2d(x, w, padding=3), None, None),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_form_matches_jax_and_literal(form):
    """Each form against the JAX function (and its fold against the JAX
    fold, channels reordered) and against the literal convolution."""
    k, jfn, tfn, literal, jfold, tfold = FORMS[form]
    rng = np.random.RandomState(sorted(FORMS).index(form))
    x = rng.randn(2, 16, 12, 5).astype(np.float32)
    w = _weights(rng, k, 5, 6)
    xt, wt = _t(x, w)
    ours = tfn(xt, wt)
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w))).transpose(0, 3, 1, 2)
    _close(ours, ref)
    lit = literal(xt, wt)
    if form == "s2d_valid":       # the VALID region is the top-left slice
        ours, lit = ours[:, :, :-6, :-6], lit[:, :, :-6, :-6]
    _close(ours, lit)
    if jfold is not None:
        jw = np.asarray(jfold(jnp.asarray(w)))          # [kh, kw, I, P*C]
        tw = tfold(wt, 6).permute(3, 4, 2, 0, 1)        # -> [kh, kw, I, P, C]
        _close(tw.reshape(jw.shape), jw)


def test_s2d_fold_matches_jax():
    """The space-to-depth kernel fold, channels reordered from the port's
    (c, phase) to JAX's (phase, c), input and output."""
    rng = np.random.RandomState(9)
    w = _weights(rng, 7, 3, 4)
    for pad in (None, 0):
        jw, jr, jc = jsub.fold_conv_kernel_s2d(jnp.asarray(w), 4, pad)
        tw, tr, tc = tsub.fold_conv_kernel_s2d(
            torch.from_numpy(w).permute(3, 2, 0, 1), 4, pad)
        assert (tuple(jr), tuple(jc)) == (tuple(tr), tuple(tc))
        Kh, Kw = tw.shape[2:]
        tw = tw.reshape(4, 16, 3, 16, Kh, Kw)           # o, (a,e), i, (u,c)
        _close(tw.permute(4, 5, 3, 2, 1, 0).reshape(jw.shape), jw)


def test_upblock_eval_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    jm = JUpBlock(features=4)
    v = jax.jit(jm.init, static_argnums=2)(jax.random.PRNGKey(0),
                                          jnp.asarray(x), False)
    v = jax.tree.map(np.asarray, v)
    v["batch_stats"] = jax.tree.map(
        lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
        v["batch_stats"])
    ref = jax.jit(jm.apply, static_argnums=2)(v, jnp.asarray(x), False)
    b = convert._StateDict(v)
    b.conv("conv", "conv")
    b.norm("norm", "norm")
    port = UpBlock(6, 4).eval()
    port.load_state_dict(b.sd)
    with torch.no_grad():
        ours = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        literal = port.literal(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-3, rtol=1e-3)
    _close(ours, literal)


def test_model_eval_forms_match_literal():
    """The dense motion heads and the generator's final conv: the eval form
    against the literal form of the same module; the keypoint heads' JAX
    form (not taken: slower on the H100) against their literal conv."""
    torch.manual_seed(0)
    gp = TINY_CONFIG["model_params"]["generator_params"]
    gen = OcclusionAwareGenerator(num_kp=10, **gp).eval()
    kpa = KPDetectorA().eval()
    with torch.no_grad():
        for m in (gen, kpa):
            for p in m.parameters():
                p.uniform_(-0.1, 0.1)
        pred = torch.randn(2, gen.dense_motion_network.mask.in_channels,
                           16, 16)
        dense = gen.dense_motion_network
        for a, b in zip(dense.heads(pred), dense.heads_literal(pred)):
            _close(a, b)
        out = torch.randn(2, gen.final.in_channels, 32, 32)
        _close(gen.final_conv(out), gen.final(out))
        fm = torch.randn(2, 35, 64, 64)
        _close(kpd.heads_conv(fm, kpa.kp, kpa.jacobian,
                              kpd.fold_heads(kpa.kp, kpa.jacobian)),
               kpd.heads_conv(fm, kpa.kp, kpa.jacobian))


def test_folded_weights_follow_load_state_dict():
    """The folds are made once per load of the weights: a later
    ``load_state_dict`` (or an in-place edit) is followed, and a call with
    the same weights reuses them."""
    torch.manual_seed(1)
    a, b = UpBlock(6, 4).eval(), UpBlock(6, 4).eval()
    x = torch.randn(1, 6, 8, 8)
    with torch.no_grad():
        a(x)
        folded = a.d2s_weight
        a(x)
        assert a.d2s_weight is folded              # not folded per call
        a.load_state_dict(b.state_dict())
        torch.testing.assert_close(a(x), b(x), rtol=0, atol=0)
        assert a.d2s_weight is not folded
        a.conv.weight.mul_(2.0)
        torch.testing.assert_close(a(x), a.literal(x), rtol=TOL, atol=TOL)
    assert "d2s_weight" not in a.state_dict()      # the reference's names
