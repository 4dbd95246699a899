"""The port's entry points and what they read, on the CPU: the reference's
checkpoints (``from_torch_checkpoints``), the preflight check, the
adapt_scale render, and the two CLIs.  The loader and the preflight are
held to the JAX package's converters and preflight (no JAX render is
compiled here), the CLIs to the port's own pipeline called directly, bit
for bit.  The host-side helpers are in tests/test_torch_entry_host.py."""
import os
import random
import threading
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import EMOTION_TINY_CONFIG, save_checkpoints
from eamm_tpu import compat as jax_compat
from eamm_tpu.compat import preflight as jax_preflight
from eamm_tpu.ops import motion as jax_motion
from eamm_tpu_torch.cli import demo, serve
from eamm_tpu_torch.compat import preflight
from eamm_tpu_torch.convert import state_dicts_from_jax
from eamm_tpu_torch.data import augmentation, preprocess
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
from eamm_tpu_torch.serve_http import decode_response, encode_request

OPTS = dict(frame_chunk=8, time_bucket=8, device="cpu")
AUGMENTATION = {"crop_mouth_param": {"center_x": 135, "center_y": 190,
                                     "mask_width": 100, "mask_height": 60}}


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
    return EammPipeline.from_random(EMOTION_TINY_CONFIG, 3,
                                    PipelineOptions(**OPTS))


@pytest.fixture(scope="module")
def env(pipe, tmp_path_factory):
    """Checkpoints of ``pipe``'s models, a config YAML of its widths with
    the mouth mask, a 0.3 s 16 kHz wav, a [4, 7] pose track, a 3-frame
    uint8 emotion clip and a source image, as files."""
    from scipy.io import wavfile
    d = tmp_path_factory.mktemp("entry")
    paths = save_checkpoints(pipe.models, str(d))
    config = {**EMOTION_TINY_CONFIG,
              "dataset_params": {"augmentation_params": AUGMENTATION}}
    paths["config"] = str(d / "config.yaml")
    with open(paths["config"], "w") as f:
        yaml.safe_dump(config, f)
    rng = np.random.RandomState(0)
    paths["wav"] = str(d / "speech.wav")
    wavfile.write(paths["wav"], 16000,
                  (0.3 * rng.randn(4800) * 32767 / 3).astype(np.int16))
    paths["pose"] = str(d / "pose.npy")
    np.save(paths["pose"], rng.randn(4, 7).astype(np.float32))
    paths["emotion"] = str(d / "emoclip.npy")
    np.save(paths["emotion"], (rng.rand(3, 256, 256, 3) * 255).astype(np.uint8))
    paths["source"] = str(d / "source.npy")
    np.save(paths["source"], rng.rand(256, 256, 3).astype(np.float32))
    paths["dir"] = str(d)
    return paths


# ------------------------------------------------------- checkpoints

def test_checkpoints_load_like_jax(pipe, env):
    """from_torch_checkpoints gives, key for key and bit for bit, the
    state_dicts that state_dicts_from_jax makes of the JAX converters'
    reading of the same files; the prefix is dropped and the final_4 keys
    are skipped and named."""
    ours = EammPipeline.from_torch_checkpoints(
        EMOTION_TINY_CONFIG, env["fomm"], env["audio"], env["emo"],
        PipelineOptions(**OPTS))
    fomm, audio, emo = (jax_compat.load_torch_checkpoint(env[k])
                        for k in ("fomm", "audio", "emo"))
    variables = {
        "generator": jax_compat.convert_generator(fomm["generator"]),
        "kp_detector": jax_compat.convert_kp_detector(fomm["kp_detector"]),
        "kp_detector_a": jax_compat.convert_kp_detector_a(
            audio["kp_detector_a"]),
        "audio_feature": jax_compat.convert_atnet(audio["audio_feature"]),
        "emo_detector": jax_compat.convert_emotion_k(emo["emo_detector"]),
    }
    ref = state_dicts_from_jax(variables)
    final_4 = [f"final_4.{i}.{p}" for i in (0, 3) for p in ("bias", "weight")]
    assert ours.ignored_keys == {"emo_detector": final_4}
    for k in final_4:                     # the JAX converters keep them
        del ref["emo_detector"][k]
    for name, model in ours.models.items():
        got = model.state_dict()
        assert got.keys() == ref[name].keys(), name
        for k, v in got.items():
            assert torch.equal(v, ref[name][k]), (name, k)
            assert torch.equal(v, pipe.models[name].state_dict()[k])


def test_checkpoint_with_an_unknown_key_is_refused(pipe, env, tmp_path):
    """Only the final_4 stack is skipped: any other key the model does not
    hold fails the strict load."""
    ckpt = torch.load(env["fomm"], weights_only=False)
    ckpt["kp_detector"]["kp.extra"] = torch.zeros(1)
    path = str(tmp_path / "fomm.pth.tar")
    torch.save(ckpt, path)
    with pytest.raises(RuntimeError, match="kp.extra"):
        EammPipeline.from_torch_checkpoints(
            EMOTION_TINY_CONFIG, path, env["audio"], env["emo"],
            PipelineOptions(**OPTS))


def _report(r):
    return (r.ok, r.fatal, r.skipped, str(r),
            [(m.name, m.family, m.missing, m.unused, m.n_matched, m.ok)
             for m in r.modules])


def test_preflight_matches_jax(env):
    """The same report as the JAX package's for each of the three files
    as saved, and, as loaded, with one key renamed and with one key
    dropped."""
    keys = {"fomm": ("generator", "module.final.weight"),
            "audio": ("kp_detector_a", "kp.weight"),
            "emo": ("emo_detector", "fc_p.0.weight")}
    for case in ("full", "renamed", "truncated"):
        for name, (entry, key) in keys.items():
            ckpt = env[name]
            if case != "full":
                ckpt = torch.load(ckpt, weights_only=False)
                value = ckpt[entry].pop(key)
                if case == "renamed":
                    ckpt[entry][key + "_renamed"] = value
            ours, ref = (preflight.check_state_dict(ckpt),
                         jax_preflight.check_state_dict(ckpt))
            assert _report(ours) == _report(ref), (case, name)
            assert ours.fatal == (case != "full"), (case, name)
            assert ours.ok == (case == "full"), (case, name)


def test_adapt_scale_render(pipe, env):
    """The staged route's scale is sqrt(area) of the source keypoints' hull
    over that of the first audio keypoints, as the JAX pipeline computes
    it; without relative movement the scale moves nothing, so the frames
    are bitwise the whole-clip render's."""
    src = np.load(env["source"])
    wav = preprocess.load_audio(env["wav"])
    pose = np.load(env["pose"])
    staged = EammPipeline(EMOTION_TINY_CONFIG, models=pipe.models,
                          options=PipelineOptions(adapt_scale=True, **OPTS))
    frames = staged.render_uint8(src, wav, pose, add_emo=False)
    T, source, w, p = pipe._prepare(src, wav, pose)
    from eamm_tpu_torch.ops.mfcc import audio_to_mfcc_windows
    kp_s, _, kp_initial = pipe.audio_keypoints(
        source, audio_to_mfcc_windows(w)[:p.shape[0]], p)
    src_area = jax_motion.convex_hull_area(kp_s["value"].numpy())
    drv_area = jax_motion.convex_hull_area(kp_initial["value"].numpy())
    assert staged.last_movement_scale == float(np.sqrt(src_area)
                                               / np.sqrt(drv_area))
    assert staged.last_movement_scale != 1.0
    np.testing.assert_array_equal(
        frames, pipe.render_uint8(src, wav, pose, add_emo=False))


# ---------------------------------------------------------------- CLIs

def _demo_argv(env, out, *extra):
    return ["--config", env["config"], "--checkpoint", env["fomm"],
            "--audio_checkpoint", env["audio"], "--emo_checkpoint",
            env["emo"], "--source_image", env["source"], "--in_file",
            env["wav"], "--pose_file", env["pose"], "--driving_video",
            env["emotion"], "--result_path", out, "--cpu", "--no_crop",
            "--no_align", *extra]


@pytest.mark.parametrize("adapt_scale", [False, True])
def test_demo_main_matches_render_uint8(env, tmp_path, adapt_scale,
                                        monkeypatch):
    """The demo's neutral and emotional frames are bitwise render_uint8 on
    the pipeline it built from the checkpoints (the CPU's matrix products
    may round differently on another copy of the same weights), its emotion
    frames bitwise the mouth mask drawn from the same seed, and its videos
    are written."""
    built = []
    build = demo.build_pipeline
    monkeypatch.setattr(demo, "build_pipeline",
                        lambda *a: built.append(build(*a)) or built[0])
    extra = ("--adapt_scale",) if adapt_scale else ()
    np.random.seed(9)
    random.seed(9)
    out = demo.main(_demo_argv(env, str(tmp_path), *extra))
    direct = built[0]
    assert direct.options.adapt_scale == adapt_scale
    assert direct.options.device == "cpu"
    src = np.load(env["source"])
    wav = preprocess.load_audio(env["wav"])
    pose = np.load(env["pose"])
    driving = np.load(env["emotion"]).astype(np.float32) / 255.0
    np.random.seed(9)
    random.seed(9)
    transformed = augmentation.AllAugmentationTransform(**AUGMENTATION)(
        driving)
    np.testing.assert_array_equal(out["transformed"], transformed)
    scale = direct.last_movement_scale
    np.testing.assert_array_equal(
        out["neutral"], direct.render_uint8(src, wav, pose, add_emo=False))
    np.testing.assert_array_equal(
        out["emotion"], direct.render_uint8(src, wav, pose, transformed))
    assert out["all"].shape == (7, 256, 768, 3)
    assert out["movement_scale"] == (scale if adapt_scale else None)
    assert (scale is None) != adapt_scale
    written = sorted(os.listdir(tmp_path))
    assert written == ["all.avi", "emotion.avi", "neutral.avi"] or \
        written == ["all.mp4", "emotion.mp4", "neutral.mp4"], written


def test_demo_refuses_a_fatal_checkpoint(env, tmp_path):
    """The preflight ends the demo with the whole report on a checkpoint
    that lacks a key."""
    ckpt = torch.load(env["fomm"], weights_only=False)
    del ckpt["kp_detector"]["kp.weight"]
    path = str(tmp_path / "fomm.pth.tar")
    torch.save(ckpt, path)
    argv = _demo_argv(env, str(tmp_path))
    argv[argv.index(env["fomm"])] = path
    with pytest.raises(SystemExit, match="missing: kp.weight"):
        demo.main(argv)


def test_serve_cli(env):
    """eamm-torch-serve --cpu on the checkpoints, warmed, answers /healthz
    and a /render equal to its pipeline's own batched render of the
    request padded to max_batch; --artifact reads the artifact it names
    (tests/test_torch_export_serve.py serves one)."""
    stop, fronts = threading.Event(), []
    argv = ["--config", env["config"], "--checkpoint", env["fomm"],
            "--audio_checkpoint", env["audio"], "--emo_checkpoint",
            env["emo"], "--cpu", "--f32", "--port", "0", "--host",
            "127.0.0.1", "--transfer_format", "rgb", "--max_batch", "2",
            "--frame_chunk", "8", "--time_bucket", "8", "--segment_frames",
            "0", "--overlap_segments", "1", "--warmup_seconds", "0.1"]
    t = threading.Thread(target=serve.main, args=(argv,),
                         kwargs=dict(stop_event=stop, ready=fronts.append))
    t.start()
    try:
        for _ in range(600):
            if fronts or not t.is_alive():
                break
            t.join(0.1)
        assert fronts, "the server did not start"
        url = fronts[0].url
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert r.read() == b"ok"
        src = np.load(env["source"])
        wav = preprocess.load_audio(env["wav"])
        pose = np.load(env["pose"])
        with urllib.request.urlopen(urllib.request.Request(
                url + "/render", data=encode_request(src, wav, pose),
                method="POST"), timeout=600) as r:
            frames = decode_response(r.read())["frames"]
        assert fronts[0].server.stats()["requests"] == 1   # warm-up reset
    finally:
        stop.set()
        t.join(60)
    direct = fronts[0].server.pipeline
    assert direct.options.compute_dtype == torch.float32
    want = direct.render_batch_uint8([src, src], [wav, wav], [pose, pose])
    np.testing.assert_array_equal(frames, want[0, :len(frames)])
    with pytest.raises(FileNotFoundError):        # --artifact loads it
        serve.main(["--artifact", "x.eammx", "--cpu"])
