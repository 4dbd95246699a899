"""The port's frozen render artifact (``eamm_tpu_torch/infer/export.py``)
on the CPU, following tests/test_export.py: programs exported with
``torch.export`` and loaded back render bitwise what the live port renders
(the programs are the functions its live routes call), bucket padding,
a failed export leaves no file, a wrong device or format version is
refused, the graphs call the ``eamm::`` operators (no plain version frozen
in), and the loaded programs read the loaded weights.

Two module-scoped artifacts at EMOTION_TINY_CONFIG widths: the batched
program and the emotional one (4 unique emotion frames) at one bucket of
8 frames, and the batched program alone at buckets of 8 and 16 frames,
on which a clip takes the smallest bucket that holds it.  Exporting takes
~5-10 s a program here, so the streamed and unbounded programs (10 more)
are held to the live port by the slow test at the end."""
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from chip_smoke import EMOTION_TINY_CONFIG
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
from eamm_tpu_torch.infer import export as ex
from eamm_tpu_torch.infer.export import RenderArtifact, export_render_artifact
from eamm_tpu_torch.models.blocks import refold_all

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
def pipe():
    return EammPipeline.from_random(EMOTION_TINY_CONFIG, 0,
                                    PipelineOptions(**OPTS))


@pytest.fixture(scope="module")
def artifact_path(pipe, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "model.eammx")
    meta = export_render_artifact(pipe, path, batch=1, frame_buckets=(8,),
                                  emotional=True, emo_frame_buckets=(4,))
    assert meta["frame_buckets"] == [8] and meta["device"] == "cpu"
    assert sorted(meta["export_seconds"]) == ["1x8", "emo_8x4"]
    return path


@pytest.fixture(scope="module")
def art(artifact_path):
    return RenderArtifact.load(artifact_path, device="cpu")


@pytest.fixture(scope="module")
def bucket_art(pipe, tmp_path_factory):
    """The batched program alone at buckets of 8 and 16 frames."""
    path = str(tmp_path_factory.mktemp("buckets") / "model.eammx")
    meta = export_render_artifact(pipe, path, batch=1, frame_buckets=(8, 16))
    assert meta["frame_buckets"] == [8, 16]
    assert sorted(meta["export_seconds"]) == ["1x16", "1x8"]
    return RenderArtifact.load(path, device="cpu")


def _req(seed, samples=5000, emotion=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(256, 256, 3).astype(np.float32),
            (0.1 * rng.randn(samples)).astype(np.float32),
            rng.randn(1, 7).astype(np.float32),
            rng.rand(emotion, 256, 256, 3).astype(np.float32))


def test_batch_roundtrip_bitwise(pipe, art):
    """A 7-frame clip (Tp 8 live and in the artifact): the batched program
    from the file against the live batched render."""
    src, wav, pose, _ = _req(0)
    got = art.render_uint8(src[None], [wav], [pose])
    np.testing.assert_array_equal(
        got, pipe.render_batch_uint8(src[None], [wav], [pose]))


def test_bucket_padding(pipe, bucket_art):
    """A 12-frame clip rides the 16 bucket; ``render`` returns the padded
    payload and the true length; past the largest bucket is refused."""
    art = bucket_art
    src, wav, pose, _ = _req(1, samples=8000)
    got = art.render_uint8(src[None], [wav], [pose])
    assert got.shape[1] == 12
    np.testing.assert_array_equal(
        got, pipe.render_batch_uint8(src[None], [wav], [pose]))
    rng = np.random.RandomState(1)
    (frames,), t = art.render(src[None], rng.randn(1, 12, 28, 12),
                              rng.randn(1, 12, 6))
    assert t == 12 and frames.shape[1] == 16
    assert art.bucket_for(3) == 8 and art.bucket_for(9) == 16
    with pytest.raises(ValueError, match="largest exported bucket"):
        art.bucket_for(17)
    with pytest.raises(ValueError, match="batch"):
        art.render(np.stack([src] * 2), rng.randn(2, 8, 28, 12),
                   rng.randn(2, 8, 6))


def test_emotional_bitwise(pipe, art):
    """4 emotion frames (the bucket) under 7 timesteps: the emotional
    program is bitwise the live emotional render of the same frames; 3
    frames padded to the bucket stay within 1 count (the trunk's batch
    differs, as in the JAX artifact)."""
    src, wav, pose, emo = _req(2, emotion=4)
    np.testing.assert_array_equal(art.render_emotional(src, wav, pose, emo),
                                  pipe.render_uint8(src, wav, pose, emo))
    got = art.render_emotional(src, wav, pose, emo[:3])
    want = pipe.render_uint8(src, wav, pose, emo[:3])
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-3


def test_graphs_call_the_kernel_operators(art, bucket_art):
    """Each warp and keypoint expectation is an ``eamm::`` call in the
    graph, once per decode chunk and per keypoint head, so a program
    exported on the card launches the kernels, never a plain version."""
    per_chunk = {"eamm.warp_wide.default": 1, "eamm.warp_narrow.default": 1}
    programs = {**art._programs, **bucket_art._programs}
    assert len(programs) == 3                 # 1x8, emo_8x4 and 1x16
    for name, program in programs.items():
        calls = [str(n.target) for n in program.graph.nodes
                 if str(n.target).startswith("eamm.")]
        t = int(name.split("x")[1] if name[0].isdigit()
                else name.split("_")[1].split("x")[0])
        for op, n in per_chunk.items():
            assert calls.count(op) == n * t // 8, (name, calls)
        # the source's and the audio keypoints' heads (and no emotion
        # map head: linear_3)
        assert calls.count("eamm.kp_expectation.default") == 2, name


def test_programs_read_the_loaded_weights(art):
    """The weights are the programs' input, not constants traced at
    export (the LSTM's flat weights too): another pipeline's weights in a
    loaded artifact render what that pipeline renders."""
    other = EammPipeline.from_random(EMOTION_TINY_CONFIG, 1,
                                     PipelineOptions(**OPTS))
    models = ex._Models(other)
    refold_all(models)
    weights = {**dict(models.named_parameters()),
               **dict(models.named_buffers())}
    assert weights.keys() == art.weights.keys()
    src, wav, pose, _ = _req(3)
    saved, art.weights = art.weights, weights
    try:
        got = art.render_uint8(src[None], [wav], [pose])
    finally:
        art.weights = saved
    np.testing.assert_array_equal(
        got, other.render_batch_uint8(src[None], [wav], [pose]))


def test_failed_export_leaves_no_file(pipe, tmp_path, monkeypatch):
    """A failure at a later program leaves neither the artifact nor its
    temporary file (the first program is a stand-in, to keep this fast)."""
    stand_in = torch.export.export(torch.nn.Identity(), (torch.zeros(1),))
    calls = []

    def export_then_fail(*args, **kwargs):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("simulated export failure")
        return stand_in

    monkeypatch.setattr(torch.export, "export", export_then_fail)
    path = str(tmp_path / "broken.eammx")
    with pytest.raises(RuntimeError, match="simulated"):
        export_render_artifact(pipe, path, batch=1, frame_buckets=(8, 16))
    assert len(calls) == 2
    assert not os.path.exists(path) and not os.path.exists(path + ".tmp")


def test_refuses_wrong_device_version_and_buckets(pipe, artifact_path,
                                                  tmp_path):
    for change, match in (({"device": "cuda:0"}, "exported on"),
                          ({"format_version": ex.FORMAT_VERSION + 1},
                           "format")):
        path = str(tmp_path / "changed.eammx")
        with zipfile.ZipFile(artifact_path) as src, \
                zipfile.ZipFile(path, "w") as dst:
            for item in src.infolist():
                data = src.read(item.filename)
                if item.filename == "meta.json":
                    data = json.dumps({**json.loads(data), **change})
                dst.writestr(item, data)
        with pytest.raises(ValueError, match=match):
            RenderArtifact.load(path, device="cpu")
    with pytest.raises(ValueError, match="exported on"):
        RenderArtifact.load(artifact_path, device="cuda")
    with pytest.raises(ValueError, match="multiple"):
        export_render_artifact(pipe, str(tmp_path / "bad.eammx"),
                               frame_buckets=(12,))
    with pytest.raises(ValueError, match="segments"):
        export_render_artifact(pipe, str(tmp_path / "bad.eammx"),
                               frame_buckets=(8,), stream_segments=2)
    assert os.listdir(tmp_path) == ["changed.eammx"]


@pytest.mark.slow
def test_stream_and_unbounded_programs_bitwise(pipe, tmp_path):
    """The streamed (2 segments of 8) and unbounded (chunks of 8) programs,
    neutral and emotional, against the live routes: bitwise."""
    import dataclasses
    path = str(tmp_path / "stream.eammx")
    export_render_artifact(pipe, path, batch=1, frame_buckets=(16,),
                           emotional=True, emo_frame_buckets=(4,),
                           stream_segments=2, unbounded_frames=8)
    art = RenderArtifact.load(path, device="cpu")
    two = EammPipeline(EMOTION_TINY_CONFIG, models=pipe.models,
                       options=PipelineOptions(overlap_segments=2, **OPTS))
    chunks = EammPipeline(EMOTION_TINY_CONFIG, models=pipe.models,
                          options=dataclasses.replace(two.options,
                                                      segment_frames=8))
    src, wav, pose, emo = _req(4, samples=10000, emotion=4)
    for video in (None, emo):
        segs = list(art.render_stream(src, wav, pose, video))
        live = list(two.render_stream(src, wav, pose, video,
                                      add_emo=video is not None))
        assert [s for s, _ in segs] == [s for s, _ in live] == [0, 8]
        for (_, a), (_, b) in zip(segs, live):
            np.testing.assert_array_equal(a, b)
        long_wav = np.concatenate([wav, wav, wav])
        segs = list(art.render_stream_unbounded(src, long_wav, pose, video))
        live = list(chunks.render_stream(src, long_wav, pose, video,
                                         add_emo=video is not None))
        assert [s for s, _ in segs] == [s for s, _ in live]
        for (_, a), (_, b) in zip(segs, live):
            np.testing.assert_array_equal(a, b)
    with zipfile.ZipFile(path) as z:
        sizes = [z.getinfo(n).file_size for n in z.namelist()
                 if n.startswith("programs/")]
        weights = z.getinfo("weights.pt").file_size
    assert max(sizes) < weights / 10                  # the weights once
