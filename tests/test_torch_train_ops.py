"""The backward of the port's three training operators against JAX (CPU).

``eamm::kp_expectation`` against ``jax.vjp`` through
``eamm_tpu.ops.kp_expectation.kp_expectation`` (its ``custom_vjp``), the
wide and narrow warps against ``jax.vjp`` of ``eamm_tpu.ops.warp.
grid_sample`` (zeros padding, both align_corners, shared sources), each
through torch autograd of the port's operator, whose CPU backward is the
plain version's autodiff; and ``torch.library.opcheck`` of the three
operators with their autograd registered.  Tolerance 1e-5 (float32
gradients summed in other orders).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from eamm_tpu.ops import warp as jax_warp
from eamm_tpu.ops.kp_expectation import kp_expectation as jax_kp_expectation
from eamm_tpu_torch.ops import kp_expectation as kpx
from eamm_tpu_torch.ops import warp_cuda

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(ours, ref):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)


def test_kp_expectation_backward_matches_jax():
    rng = np.random.RandomState(0)
    pred = rng.randn(2, 10, 13, 17).astype(np.float32)
    jmap = rng.randn(2, 10, 4, 13, 17).astype(np.float32)
    g_value = rng.randn(2, 10, 2).astype(np.float32)
    g_jac = rng.randn(2, 10, 2, 2).astype(np.float32)
    _, vjp = jax.vjp(lambda p, j: jax_kp_expectation(p, j, 0.1),
                     jnp.asarray(pred), jnp.asarray(jmap))
    want_pred, want_jmap = vjp((jnp.asarray(g_value), jnp.asarray(g_jac)))

    p = torch.tensor(pred, requires_grad=True)
    j = torch.tensor(jmap, requires_grad=True)
    value, jac = kpx.kp_expectation(p, j, 0.1)
    torch.autograd.backward((value, jac),
                            (torch.tensor(g_value), torch.tensor(g_jac)))
    _close(p.grad, want_pred)
    _close(j.grad, want_jmap)
    plain = kpx.kp_expectation_backward(torch.tensor(pred), torch.tensor(jmap),
                                        0.1, torch.tensor(g_value),
                                        torch.tensor(g_jac))
    torch.testing.assert_close(plain[0], p.grad, rtol=0, atol=0)
    torch.testing.assert_close(plain[1], j.grad, rtol=0, atol=0)


@pytest.mark.parametrize("kind,C,align,group", [
    ("narrow", 3, False, 1), ("narrow", 3, True, 3),
    ("wide", 16, False, 1), ("wide", 16, True, 2)])
def test_warp_backward_matches_jax(kind, C, align, group):
    """Image and grid gradients of the port's warp operator against JAX's
    grid_sample of the source repeated per grid; grids from U(-1.2, 1.2),
    so corners fall outside the image."""
    rng = np.random.RandomState(1)
    Bi = 2
    image = rng.randn(Bi, 9, 11, C).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (Bi * group, 7, 6, 2)).astype(np.float32)
    g_out = rng.randn(Bi * group, 7, 6, C).astype(np.float32)

    def jax_fn(img, grd):
        return jax_warp.grid_sample(jnp.repeat(img, group, axis=0), grd,
                                    align_corners=align)
    _, vjp = jax.vjp(jax_fn, jnp.asarray(image), jnp.asarray(grid))
    want_image, want_grid = vjp(jnp.asarray(g_out))

    warp = (warp_cuda.grid_sample_narrow if kind == "narrow"
            else warp_cuda.grid_sample_wide)
    i = torch.tensor(image, requires_grad=True)
    g = torch.tensor(grid, requires_grad=True)
    warp(i, g, align).backward(torch.tensor(g_out))
    _close(i.grad, want_image)
    _close(g.grad, want_grid)


@pytest.mark.parametrize("name", ["kp_expectation", "warp_wide",
                                  "warp_narrow"])
def test_opcheck_with_autograd(name):
    """Schema, fake tensors, autograd registration and AOT dispatch of the
    operator, float32 on the CPU."""
    gen = torch.Generator().manual_seed(2)
    if name == "kp_expectation":
        op = kpx.kp_expectation_op
        args = (torch.randn(2, 3, 5, 6, generator=gen, requires_grad=True),
                torch.randn(2, 3, 4, 5, 6, generator=gen, requires_grad=True),
                0.1)
    else:
        op = (warp_cuda.warp_wide_op if name == "warp_wide"
              else warp_cuda.warp_narrow_op)
        C = 8 if name == "warp_wide" else 3
        args = (torch.randn(2, 6, 7, C, generator=gen, requires_grad=True),
                (torch.rand(4, 5, 3, 2, generator=gen) * 2.4 - 1.2
                 ).requires_grad_(), False)
    torch.library.opcheck(op, args)
