"""The port's delivery and streaming render on the CPU (the colorspace,
chunked MFCC, one-euro carry and the batched render are in
tests/test_torch_delivery_batch.py, which takes this file's pipeline).

These hold the port against itself, on one module-scoped pipeline of
random weights at ``chip_smoke.EMOTION_TINY_CONFIG`` widths (frame_chunk
8, time_bucket 8):
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
import numpy as np
import pytest
import torch

from chip_smoke import EMOTION_TINY_CONFIG
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
from eamm_tpu_torch.ops import colorspace

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
