"""The port's delivery, streaming and batched render on the CPU.

The colorspace, chunked MFCC and one-euro carry are held to the JAX
functions on the same seeded numpy inputs.  The rest holds the port
against itself, on one module-scoped pipeline of random weights at
``chip_smoke.EMOTION_TINY_CONFIG`` widths (frame_chunk 8, time_bucket 8):
the whole-clip renders these paths are compared with are held to the JAX
pipeline by tests/test_torch_pipeline.py and
tests/test_torch_emotion_pipeline.py, and the slice as a whole by
tests/test_torch_pipeline.py::test_stream_yuv420_matches_jax and
::test_batch_keypoints_match_jax.

Bounds, as the JAX package's own tests set them
(tests/test_infer_pipeline.py): overlapped segments and the bounded stream
equal one segment bit for bit; the unbounded chunks and the batch within
one uint8 count of the whole clip and of one clip; yuv420 delivery and the
packed emotion upload within mean 5e-3 and max 0.2 (in [0, 1]) of RGB."""
import jax
import numpy as np
import pytest
import torch

from chip_smoke import EMOTION_TINY_CONFIG
from eamm_tpu.ops import colorspace as jax_colorspace
from eamm_tpu.ops import filters as jax_filters
from eamm_tpu.ops.mfcc import mfcc_window_chunk as jax_window_chunk
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
from eamm_tpu_torch.ops import colorspace, mfcc
from eamm_tpu_torch.ops.filters import one_euro_filter, one_euro_init

OPTS = dict(frame_chunk=8, time_bucket=8, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once, and a torch per worker spinning a thread per core
    slows every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port():
    return EammPipeline.from_random(EMOTION_TINY_CONFIG, 0,
                                    PipelineOptions(**OPTS))


def _variant(port, **options):
    """``port``'s models under other options."""
    return EammPipeline(EMOTION_TINY_CONFIG, models=port.models,
                        options=PipelineOptions(**{**OPTS, **options}))


def _clip(seconds=0.5, seed=0):
    """source, waveform, pose, 5 emotion frames; 0.5 s is 12 frames."""
    rng = np.random.RandomState(seed)
    src = rng.rand(256, 256, 3).astype(np.float32)
    wav = (0.1 * rng.randn(int(16000 * seconds))).astype(np.float32)
    pose = rng.randn(1, 7).astype(np.float32)
    emo = rng.rand(5, 256, 256, 3).astype(np.float32)
    return src, wav, pose, emo


_renders = {}


def _whole(port, emotional: bool):
    """The whole-clip rgb render of ``_clip()``, once a module."""
    key = ("rgb", emotional)
    if key not in _renders:
        src, wav, pose, emo = _clip()
        _renders[key] = port.render_uint8(src, wav, pose,
                                          emo if emotional else None,
                                          add_emo=emotional)
    return _renders[key]


def _whole_yuv(port, emotional: bool):
    """The whole-clip yuv420 render of ``_clip()``, once a module; the
    emotional one is given the emotion frames as packed planes."""
    key = ("yuv420", emotional)
    if key not in _renders:
        src, wav, pose, emo = _clip()
        video = colorspace.pack_yuv420_np(emo) if emotional else None
        _renders[key] = _variant(port, transfer_format="yuv420"
                                 ).render_yuv420(src, wav, pose, video,
                                                 add_emo=emotional)
    return _renders[key]


def _max_count(a, b) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _codec_error(a, b):
    err = np.abs(a.astype(np.float32) - b.astype(np.float32)) / 255.0
    return err.mean(), err.max()


# ------------------------------------------------------------ ops vs JAX

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


# ------------------------------------------------------------ delivery

def test_overlap_matches_single(port):
    """An emotional yuv420 render from packed emotion planes, through the
    split keypoint stage, in three segments of 8 frames (Tp 24: the second
    holds 4 real frames, the third only padding and is not decoded) equals
    one segment bit for bit (the neutral rgb case is the bounded stream's
    below)."""
    src, wav, pose, emo = _clip()
    ov = _variant(port, transfer_format="yuv420", overlap_segments=3)
    out = ov.render_yuv420(src, wav, pose, colorspace.pack_yuv420_np(emo),
                           add_emo=True)
    assert out[0].shape[0] == 12
    for o, s in zip(out, _whole_yuv(port, True)):
        np.testing.assert_array_equal(o, s)


def test_render_stream_bounded_matches_whole(port):
    """A neutral rgb stream in three overlapped segments (as above): its
    segments in order, frames 0 and 8, put together bit for bit the whole
    clip in one segment; adapt_scale refuses."""
    src, wav, pose, _ = _clip()
    ov = _variant(port, overlap_segments=3)
    segs = list(ov.render_stream(src, wav, pose, add_emo=False))
    assert [s for s, _ in segs] == [0, 8]
    assert [p.shape[0] for _, p in segs] == [8, 4]
    np.testing.assert_array_equal(np.concatenate([p for _, p in segs]),
                                  _whole(port, False))
    with pytest.raises(ValueError, match="adapt_scale"):
        next(_variant(port, overlap_segments=3, adapt_scale=True)
             .render_stream(src, wav, pose, add_emo=False))


@pytest.mark.parametrize("case", ["neutral", "frames", "handle"])
def test_unbounded_matches_whole(port, case):
    """Chunks with the recurrent state carried, within one count of the
    whole clip: neutral in three chunks of 4 frames (frame_chunk 4), the
    host waiting for the first while the third is queued; emotional from
    raw frames and from a handle in two chunks of 8 (5 frames < T, the
    index wrapping inside a chunk: both take the trunk route)."""
    src, wav, pose, emo = _clip()
    emotional = case != "neutral"
    K = 8 if emotional else 4
    un = _variant(port, frame_chunk=K, segment_frames=K)
    video = None
    if emotional:
        video = emo if case == "frames" else un.prepare_emotion(emo)
    segs = list(un.render_stream(src, wav, pose, video, add_emo=emotional))
    assert [s for s, _ in segs] == list(range(0, 12, K))
    got = np.concatenate([p for _, p in segs])
    assert _max_count(got, _whole(port, emotional)) <= 1


def test_use_unbounded_policy(port):
    """The JAX package's routing (tests/test_stream_policy.py): a policy
    splits by length, segment_frames alone always chunks, none never; the
    whole-clip renderers follow it."""
    policy = _variant(port, segment_frames=8, stream_policy_frames=20)
    assert not policy.use_unbounded(20) and policy.use_unbounded(21)
    assert _variant(port, segment_frames=8).use_unbounded(1)
    assert not port.use_unbounded(10_000)
    routes = []
    policy._render_stream_unbounded = lambda *a: routes.append("chunks") \
        or iter(())
    policy._render_segments = lambda *a: routes.append("whole") or iter(
        [(0, (np.zeros(1),))])
    policy.render_uint8(*_clip()[:3], add_emo=False)             # 12 frames
    list(policy.render_stream(*_clip(1.0)[:3], add_emo=False))   # 25 frames
    assert routes == ["whole", "chunks"]


def test_packed_emotion_upload(port):
    """On a yuv420 pipeline float emotion frames travel as the packed
    planes a caller may also pass (the same bytes), packed planes give the
    same frames on any pipeline, and the render from packed planes stays
    within the codec bound of the RGB emotional render."""
    emo = _clip()[3]
    yuv = _variant(port, transfer_format="yuv420")
    packed = colorspace.pack_yuv420_np(emo)
    torch.testing.assert_close(yuv._upload_emotion(emo),
                               torch.from_numpy(packed), rtol=0, atol=0)
    torch.testing.assert_close(port._emotion_frames(packed),
                               yuv._emotion_frames(emo), rtol=0, atol=0)
    mean, peak = _codec_error(
        colorspace.yuv420_to_rgb(*_whole_yuv(port, True)), _whole(port, True))
    assert mean < 5e-3 and peak < 0.2, (mean, peak)


# ------------------------------------------------------------ batch

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
