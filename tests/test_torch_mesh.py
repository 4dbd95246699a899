"""The port's rendering over a mesh of devices (``parallel/mesh.py``,
``EammPipeline.use_mesh``) on the CPU, following
tests/test_sharded_inference.py and tests/test_serve.py's mesh test:
identities sharded over ``Mesh(["cpu", "cpu"])`` against the unsharded
batched render, one clip's frames time-sharded over a mesh of 4 (whole,
and streamed in overlapped segments) against the unsharded clip, and a
``RenderServer`` over a meshed pipeline against the plain server.  The
bound is JAX's: within one uint8 count (a convolution over a shard may
round its sums otherwise than over the whole batch).  The unsharded port
render is held to JAX in tests/test_torch_pipeline.py."""
import numpy as np
import pytest
import torch

from chip_smoke import EMOTION_TINY_CONFIG
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
from eamm_tpu_torch.parallel import (Mesh, host_cpu_mesh, replicate_tree,
                                     split_sizes)
from eamm_tpu_torch.serve import RenderServer

OPTS = dict(frame_chunk=8, time_bucket=8, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pipe():
    return EammPipeline.from_random(EMOTION_TINY_CONFIG, 0,
                                    PipelineOptions(**OPTS))


def _variant(pipe, **options):
    return EammPipeline(EMOTION_TINY_CONFIG, models=pipe.models,
                        options=PipelineOptions(**{**OPTS, **options}))


def _req(seed, seconds=0.3):
    rng = np.random.RandomState(seed)
    return (rng.rand(256, 256, 3).astype(np.float32),
            (0.1 * rng.randn(int(16000 * seconds))).astype(np.float32),
            rng.randn(1, 7).astype(np.float32))


def _within_one(a, b):
    assert a.shape == b.shape
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_batch_render_sharded_matches_unsharded(pipe):
    """Three identities of different lengths over two devices (shards of
    2 and 1, each padded to the whole batch's length), as yuv420 planes in
    two overlapped segments, each segment's shards joined."""
    reqs = [_req(1, 0.3), _req(2, 0.2), _req(3, 0.25)]
    args = (np.stack([r[0] for r in reqs]), [r[1] for r in reqs],
            [r[2] for r in reqs])
    mesh = host_cpu_mesh(2)
    yuv = dict(transfer_format="yuv420", overlap_segments=2)
    sharded = _variant(pipe, **yuv).use_mesh(mesh)
    assert sharded.mesh is mesh and sharded._replicas == [sharded] * 2
    for got, want in zip(sharded.render_batch_yuv420(*args),
                         _variant(pipe, **yuv).render_batch_yuv420(*args)):
        _within_one(got, want)


def test_time_sharded_single_clip_matches_unsharded(pipe):
    """``use_mesh(time_shard=True)``: each decode chunk's 8 frames over 4
    devices; the whole clip, then the overlapped stream (frame_chunk 4,
    two segments) and the unbounded chunks, against the unsharded clip."""
    src, wav, pose = _req(4, 0.3)
    plain = pipe.render_uint8(src, wav, pose, add_emo=False)
    mesh = host_cpu_mesh(4)
    calls = []
    shp = _variant(pipe).use_mesh(mesh, time_shard=True)
    decode = shp.generator.decode

    def counted(*args, **kwargs):           # frames a decode call takes
        calls.append(args[2]["value"].shape[0])
        return decode(*args, **kwargs)

    shp.generator.decode = counted
    try:
        _within_one(shp.render_uint8(src, wav, pose, add_emo=False), plain)
    finally:
        del shp.generator.decode
    assert calls and set(calls) == {2}          # 8 frames in 4 parts
    for options in (dict(frame_chunk=4, overlap_segments=2),
                    dict(segment_frames=8)):
        ov = _variant(pipe, **options).use_mesh(mesh, time_shard=True)
        got = np.concatenate([p for _, p in ov.render_stream(
            src, wav, pose, add_emo=False)], axis=0)
        _within_one(got, plain)
    with pytest.raises(ValueError, match="multiple"):
        _variant(pipe, frame_chunk=6).use_mesh(mesh, time_shard=True)


def test_server_over_device_mesh(pipe):
    """A RenderServer over ``use_mesh``: its coalesced dispatches shard the
    identities over the mesh and match the plain server's results."""
    reqs = [_req(50), _req(51)]
    results = []
    for p in (pipe, _variant(pipe, time_bucket=32).use_mesh(
            host_cpu_mesh(2))):
        server = RenderServer(p, max_batch=2, max_delay_ms=300)
        try:
            results.append([f.result(600) for f in
                            [server.submit(*r) for r in reqs]])
        finally:
            server.stop()
    for got, want in zip(*results):
        _within_one(got, want)


def test_mesh_helpers():
    """The mesh, the shard sizes the batched routes take (any N, the
    larger shards first) and ``replicate_tree`` on a single-process
    mesh."""
    mesh = Mesh(("cpu", "cpu", "cpu"))
    assert mesh.size == 3 and host_cpu_mesh(3) == mesh
    assert split_sizes(7, 3) == [3, 2, 2] and split_sizes(2, 3) == [1, 1, 0]
    module = torch.nn.Linear(2, 2)
    assert all(m is module for m in replicate_tree(module, mesh))
    x = torch.arange(4.0)
    assert all(t.data_ptr() == x.data_ptr()
               for t in replicate_tree({"x": x}, mesh)[0].values())
