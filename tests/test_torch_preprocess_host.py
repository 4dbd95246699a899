"""The port's preprocessing host side against the JAX package's, on the
CPU: the pose helpers (``data/pose.py``, ``estimate_pose_clip``) within
1e-6, the native PNG decoder bitwise ``eamm_tpu.data.native``'s, the
packs (``pack_clip`` / ``pack_tree``) byte for byte, ``utils/profiling``,
and each ``eamm-torch-preprocess`` subcommand against
``eamm_tpu.cli.preprocess``'s outputs (the MFCC windows within 1e-5 of
each cepstrum's largest magnitude)."""
import os
import shutil

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from eamm_tpu.cli import preprocess as jax_cli
from eamm_tpu.data import native as jax_native
from eamm_tpu.data import packed as jax_packed
from eamm_tpu.data import pose as jax_pose
from eamm_tpu.data import preprocess as jax_preprocess
from eamm_tpu.utils import profiling as jax_profiling
from eamm_tpu_torch.cli import preprocess as cli
from eamm_tpu_torch.data import native, packed, pose, preprocess
from eamm_tpu_torch.data.datasets import _read_frames
from eamm_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once, and a torch per worker spinning a thread per core
    slows every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _landmarks(rng, n: int) -> np.ndarray:
    """n sets of 68 landmarks: the template turned, scaled, moved and
    jittered."""
    template = preprocess.load_template()
    out = []
    for _ in range(n):
        a = rng.uniform(-0.3, 0.3)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        out.append(template @ rot.T * rng.uniform(0.8, 1.2)
                   + rng.uniform(-20, 20, 2) + rng.randn(68, 2))
    return np.stack(out)


def test_pose_helpers_match_jax():
    """P2sRt, matrix2angle (both branches near +-90 degrees of pitch too),
    angle2matrix, template_3d, camera_from_landmarks, pose_from_landmarks,
    pose_from_param and estimate_pose_clip given landmarks: within 1e-6."""
    rng = np.random.RandomState(0)
    for _ in range(4):
        P = rng.randn(3, 4)
        for a, b in zip(pose.P2sRt(P), jax_pose.P2sRt(P)):
            np.testing.assert_allclose(a, b, atol=1e-6)
        np.testing.assert_allclose(pose.pose_from_param(P.reshape(-1)),
                                   jax_pose.pose_from_param(P.reshape(-1)),
                                   atol=1e-6)
    for theta in ([0.3, -0.2, 0.1], [0.1, 1.5707, 0.2], [0.1, -1.5707, 0.2]):
        R = pose.angle2matrix(theta)
        np.testing.assert_allclose(R, jax_pose.angle2matrix(theta), atol=1e-6)
        R[2, 0] = np.clip(R[2, 0] * 1.01, -1, 1)
        np.testing.assert_allclose(pose.matrix2angle(R),
                                   jax_pose.matrix2angle(R), atol=1e-6)
    template = preprocess.load_template()
    np.testing.assert_allclose(pose.template_3d(template),
                               jax_pose.template_3d(template), atol=1e-6)
    lms = _landmarks(rng, 3)
    t3 = pose.template_3d(template)
    np.testing.assert_allclose(pose.camera_from_landmarks(lms[0], t3),
                               jax_pose.camera_from_landmarks(lms[0], t3),
                               atol=1e-6)
    frames = rng.rand(3, 32, 32, 3).astype(np.float32)
    np.testing.assert_allclose(
        preprocess.estimate_pose_clip(frames, per_frame_landmarks=lms),
        jax_preprocess.estimate_pose_clip(frames, per_frame_landmarks=lms),
        atol=1e-6)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """Six seeded 40x48 RGB PNGs (one grey, one with alpha) written by
    imageio."""
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.RandomState(1)
    paths = []
    for i in range(6):
        img = (rng.rand(40, 48, 3) * 255).astype(np.uint8)
        if i == 4:
            img = img[..., 0]
        if i == 5:
            img = np.concatenate([img, img[..., :1]], -1)
        paths.append(str(d / f"{i}.png"))
        imageio.imwrite(paths[-1], img)
    return paths


def test_native_decoder_matches_jax(pngs, monkeypatch):
    """The port's library builds here and decodes bitwise as the JAX
    package's (at the files' size and resized to 24x20), within 1e-6 of
    imageio; a missing file raises naming it; the dataset reader decodes
    through it.  Without the library the imageio fallback decodes within
    1e-6 of it, and bitwise as the JAX package's fallback on the colour
    files (JAX's cuts a grey file's columns before stacking them: its
    fallback misreads one, the port's reads it as the library does)."""
    assert native.native_available() and jax_native.native_available()
    assert native.build_error() is None
    for h, w in ((40, 48), (24, 20)):
        ours = native.decode_batch(pngs, h, w, n_threads=3)
        assert ours.shape == (6, h, w, 3) and ours.dtype == np.float32
        np.testing.assert_array_equal(ours,
                                      jax_native.decode_batch(pngs, h, w))
    ref = np.stack([np.asarray(imageio.imread(p)) for p in pngs[:4]])
    np.testing.assert_allclose(native.decode_batch(pngs[:4], 40, 48),
                               ref.astype(np.float32) / 255.0, atol=1e-6)
    with pytest.raises(IOError, match="nonexistent"):
        native.decode_batch(pngs[:2] + ["/nonexistent/x.png"], 40, 48)
    np.testing.assert_array_equal(_read_frames(pngs[:3]),
                                  jax_native.decode_batch(pngs[:3], 40, 48))
    decoded = native.decode_batch(pngs, 40, 48)
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    np.testing.assert_allclose(native.decode_batch(pngs, 40, 48), decoded,
                               atol=1e-6, rtol=0)
    colour = pngs[:4] + pngs[5:]
    for h, w in ((40, 48), (24, 20)):
        np.testing.assert_array_equal(native.decode_batch(colour, h, w),
                                      jax_native.decode_batch(colour, h, w))


def test_profiling_matches_jax(tmp_path, monkeypatch):
    """StepTimer's summary on the same tick times is the JAX package's;
    trace writes a Chrome trace; without a card there are no device
    memory rows."""
    ticks = [0.0, 0.5, 0.6, 0.75, 1.5, 1.6]
    timers = {}
    for name, module in (("port", profiling), ("jax", jax_profiling)):
        clock = iter(ticks)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
        timers[name] = module.StepTimer(warmup=1)
        for _ in ticks:
            timers[name].tick()
    monkeypatch.undo()
    assert timers["port"].summary() == timers["jax"].summary()
    assert timers["port"].steps_per_sec == timers["jax"].steps_per_sec
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert prof.key_averages()
    assert profiling.device_memory_stats() == []


def _clip_tree(root, rng) -> None:
    """Two clip directories of 30x24 frame PNGs (ids 0..4, one not
    listed in order) and a directory without frames."""
    for clip in ("a/c0", "b/c1"):
        d = os.path.join(root, clip)
        os.makedirs(d)
        for i in (3, 0, 1, 4, 2):
            imageio.imwrite(os.path.join(d, f"{i}.png"),
                            (rng.rand(30, 24, 3) * 255).astype(np.uint8))
    os.makedirs(os.path.join(root, "empty"))
    np.save(os.path.join(root, "empty", "x.npy"), np.zeros(3))


@pytest.mark.parametrize("sub", ["crop", "align", "mfcc", "pose", "pack"])
def test_cli_matches_jax(sub, tmp_path):
    """Each subcommand on the same files through eamm-torch-preprocess and
    the JAX package's CLI: the crop's and the aligned frames' PNGs decode
    equal, the MFCC windows within 1e-5 of each cepstrum's largest
    magnitude (the port's on the CPU), the poses
    (from 3DMM parameters and from frames) within 1e-6, the packs byte for
    byte (and pack_clip's, and frame ids and pixels read back)."""
    rng = np.random.RandomState(2)
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    if sub == "crop":
        image = str(tmp_path / "face.png")
        imageio.imwrite(image, (rng.rand(300, 280, 3) * 255).astype(np.uint8))
        lm = str(tmp_path / "lm.npy")
        np.save(lm, _landmarks(rng, 1)[0] + 30)
        for main, out in ((cli.main, ours), (jax_cli.main, ref)):
            main(["crop", "--image", image, "--out", out + ".png",
                  "--landmarks", lm])
        np.testing.assert_array_equal(imageio.imread(ours + ".png"),
                                      imageio.imread(ref + ".png"))
    elif sub == "align":
        frames = str(tmp_path / "clip.npy")
        np.save(frames, (rng.rand(3, 96, 96, 3) * 255).astype(np.uint8))
        lm = str(tmp_path / "lm.npy")
        np.save(lm, _landmarks(rng, 1)[0] * 0.3)
        for main, out in ((cli.main, ours), (jax_cli.main, ref)):
            main(["align", "--frames", frames, "--out-dir", out,
                  "--landmarks", lm])
        assert sorted(os.listdir(ours)) == sorted(os.listdir(ref)) == \
            ["0.png", "1.png", "2.png"]
        for name in os.listdir(ref):
            np.testing.assert_array_equal(
                imageio.imread(os.path.join(ours, name)),
                imageio.imread(os.path.join(ref, name)))
    elif sub == "mfcc":
        wav = str(tmp_path / "a.wav")
        wavfile.write(wav, 16000, (rng.randn(12000) * 3000).astype(np.int16))
        a = cli.main(["mfcc", "--audio", wav, "--out-dir", ours, "--name",
                      "clip0", "--cpu"])
        b = jax_cli.main(["mfcc", "--audio", wav, "--out-dir", ref,
                          "--name", "clip0"])
        a, b = np.load(a), np.load(b)
        assert a.shape == b.shape == (18, 28, 13) and a.dtype == b.dtype
        # 1e-5 of each cepstrum's largest |value|: the log energy reaches
        # 16 and cepstrum 1 43 here, where float32's spacing is 2e-6 and
        # 4e-6, and the two FFTs and DCTs differ by up to 5.3e-5
        scale = np.abs(b).max(axis=(0, 1))
        assert (np.abs(a - b) <= 1e-5 * scale).all(), \
            (np.abs(a - b) / scale).max()
    elif sub == "pose":
        params = str(tmp_path / "params.npy")
        np.save(params, rng.randn(4, 62))
        frames = str(tmp_path / "clip.npy")
        np.save(frames, (rng.rand(2, 128, 128, 3) * 255).astype(np.uint8))
        for source in (["--params", params], ["--frames", frames]):
            cli.main(["pose", *source, "--out", ours + ".npy"])
            jax_cli.main(["pose", *source, "--out", ref + ".npy"])
            a, b = np.load(ours + ".npy"), np.load(ref + ".npy")
            assert a.shape == b.shape and a.shape[1] == 7
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
        with pytest.raises(SystemExit):
            cli.main(["pose", "--out", ours + ".npy"])
    else:
        _clip_tree(ours, rng)
        shutil.copytree(ours, ref)
        assert cli.main(["pack", "--root", ours, "--quiet"]) == 2
        assert jax_cli.main(["pack", "--root", ref, "--quiet"]) == 2
        for clip in ("a/c0", "b/c1"):
            a = os.path.join(ours, clip, packed.PACK_NAME)
            b = os.path.join(ref, clip, jax_packed.PACK_NAME)
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), clip
            assert packed.frame_ids(a) == [0, 1, 2, 3, 4]
            frame = imageio.imread(os.path.join(ours, clip, "3.png"))
            np.testing.assert_array_equal(
                packed.read_frames(a, [3], dtype=np.uint8)[0], frame)
            os.remove(a)
            assert packed.pack_clip(os.path.join(ours, clip)) == a
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), clip
        assert packed.pack_clip(os.path.join(ours, "empty")) is None
