"""What the port's streams and batches are made of, on the CPU: the
colorspace, chunked MFCC and one-euro carry against the JAX functions on
the same seeded numpy inputs, ATNet's carried window features against its
``forward``, and the batched render against one clip's, on
tests/test_torch_delivery_stream.py's pipeline, at its bounds."""
import jax
import numpy as np
import torch

from eamm_tpu.ops import colorspace as jax_colorspace
from eamm_tpu.ops import filters as jax_filters
from eamm_tpu.ops.mfcc import mfcc_window_chunk as jax_window_chunk
from eamm_tpu_torch.ops import colorspace, mfcc
from eamm_tpu_torch.ops.filters import one_euro_filter, one_euro_init
from tests.test_torch_delivery_stream import (_max_count, _variant,  # noqa: F401
                                              one_thread, port)


def test_colorspace_matches_jax():
    """uint8 planes equal the JAX functions' but for one count at rounding
    ties; unpacked floats within 1e-6."""
    rng = np.random.RandomState(0)
    rgb = rng.rand(3, 16, 24, 3).astype(np.float32)
    ours = colorspace.rgb_to_yuv420(torch.from_numpy(rgb))
    ref = jax_colorspace.rgb_to_yuv420(jax.numpy.asarray(rgb))
    assert [o.shape for o in ours] == [(3, 16, 24), (3, 8, 12), (3, 8, 12)]
    for o, r in zip(ours, ref):
        assert o.dtype == torch.uint8
        assert _max_count(o.numpy(), np.asarray(r)) <= 1
    packed = colorspace.pack_yuv420_np(rgb)
    assert packed.shape == (3, 24, 24)
    assert _max_count(packed, jax_colorspace.pack_yuv420_np(rgb)) <= 1
    np.testing.assert_allclose(
        colorspace.unpack_yuv420(torch.from_numpy(packed)).numpy(),
        np.asarray(jax_colorspace.unpack_yuv420(jax.numpy.asarray(packed))),
        atol=1e-6)
    planes = [o.numpy() for o in ours]
    np.testing.assert_array_equal(colorspace.yuv420_to_rgb(*planes),
                                  jax_colorspace.yuv420_to_rgb(*planes))


def test_mfcc_window_chunk_matches_whole_clip_and_jax():
    """Three chunks of K = 5 windows over one zero-padded buffer: within
    1e-5 of the whole clip's windows and 1e-4 of JAX's chunks."""
    K, n_chunks = 5, 3
    wav = (0.1 * np.random.RandomState(1).randn(9000)).astype(np.float32)
    buf = np.zeros(max(mfcc.padded_buffer_len(K * n_chunks),
                       2 * mfcc.PAD_SAMPLES + wav.size), np.float32)
    buf[mfcc.PAD_SAMPLES:mfcc.PAD_SAMPLES + wav.size] = wav
    whole = mfcc.mfcc_windows(mfcc.mfcc(torch.from_numpy(buf)))
    for c in range(n_chunks):
        s0 = mfcc.chunk_sample_start(c * K)
        samples = buf[s0:s0 + mfcc.chunk_samples_len(K)]
        prev = buf[s0 - 1] if s0 else 0.0
        ours = mfcc.mfcc_window_chunk(torch.from_numpy(samples), prev, K)
        assert ours.shape == (K, 28, 12)
        np.testing.assert_allclose(ours.numpy(), whole[c * K:(c + 1) * K],
                                   atol=1e-5)
        ref = jax_window_chunk(jax.numpy.asarray(samples),
                               jax.numpy.float32(prev), K)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def test_one_euro_carry_matches_whole_and_jax():
    """In chunks of 7, 1 and 12 steps with the state carried: bit for bit
    the whole sequence, and within 1e-6 of JAX's with its carry (the state,
    in the x10 domain, compared back in the values' own)."""
    x = np.cumsum(np.random.RandomState(2).randn(20, 10, 2), 0).astype(
        np.float32) * 0.05
    kw = dict(mincutoff=0.05, beta=8.0, freq=100, scale=10.0)
    whole = one_euro_filter(torch.from_numpy(x), **kw)
    carry = one_euro_init((10, 2))
    jcarry = jax_filters.one_euro_init((10, 2))
    for a, b in ((0, 7), (7, 8), (8, 20)):
        ours, carry = one_euro_filter(torch.from_numpy(x[a:b]), carry=carry,
                                      return_carry=True, **kw)
        ref, jcarry = jax_filters.one_euro_filter(
            jax.numpy.asarray(x[a:b]), carry=jcarry, return_carry=True, **kw)
        assert torch.equal(ours, whole[a:b])
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
    for o, r in zip(carry[:3], jcarry[:3]):
        np.testing.assert_allclose(o.numpy() / 10, np.asarray(r) / 10,
                                   atol=1e-6)
    np.testing.assert_array_equal(carry[3].numpy(), np.asarray(jcarry[3]))


def test_window_features_carry_matches_forward(port):
    """ATNet over two chunks of windows with the LSTM's (h, c) carried:
    within 1e-5 of ``forward`` over all of them."""
    net = port.models["audio_feature"]
    rng = np.random.RandomState(3)
    image = torch.from_numpy(rng.rand(1, 3, 256, 256).astype(np.float32))
    audio = torch.from_numpy(rng.randn(1, 6, 28, 12).astype(np.float32))
    pose = torch.from_numpy(rng.randn(1, 6, 6).astype(np.float32))
    with torch.no_grad():
        whole = net(image, audio, pose, audio_weight=1.6)
        feature = net.encode_image(image)
        carry = net.zero_carry(1)
        outs = []
        for a, b in ((0, 4), (4, 6)):
            out, carry = net.window_features(feature, audio[:, a:b],
                                             pose[:, a:b], 1.6, carry=carry,
                                             return_carry=True)
            outs.append(out)
    assert carry[0].shape == (3, 1, 256)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(),
                               atol=1e-5)


def _batch_inputs():
    """Two identities of 8 frames (a pose held) and 5 frames (a pose
    track)."""
    rng = np.random.RandomState(4)
    sources = rng.rand(2, 256, 256, 3).astype(np.float32)
    wavs = [(0.1 * rng.randn(n)).astype(np.float32) for n in (5600, 3600)]
    poses = [rng.randn(1, 7).astype(np.float32),
             rng.randn(5, 7).astype(np.float32)]
    return sources, wavs, poses


_batch = {}


def _batch_rgb(port):
    """``render_batch_uint8`` of ``_batch_inputs()`` in one segment, once a
    module."""
    if not _batch:
        _batch["rgb"] = port.render_batch_uint8(*_batch_inputs())
    return _batch["rgb"]


def test_batch_matches_single(port):
    """Each identity's frames within one count of its own render; past its
    length the padded tail."""
    sources, wavs, poses = _batch_inputs()
    out = _batch_rgb(port)
    assert out.shape == (2, 8, 256, 256, 3) and out.dtype == np.uint8
    for i in range(2):
        single = port.render_uint8(sources[i], wavs[i], poses[i],
                                   add_emo=False)
        assert len(single) == (8, 5)[i]
        assert _max_count(out[i, :len(single)], single) <= 1


def test_batch_overlap_matches_single(port):
    """The batch's overlapped render (two segments of 8, the second only
    padding and not decoded) equals its single dispatch bit for bit (the
    batch's keypoints are held to the JAX package's by
    tests/test_torch_pipeline.py::test_batch_keypoints_match_jax)."""
    ov = _variant(port, overlap_segments=2)
    np.testing.assert_array_equal(ov.render_batch_uint8(*_batch_inputs()),
                                  _batch_rgb(port))
