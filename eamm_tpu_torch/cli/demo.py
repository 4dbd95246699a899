"""``eamm-torch-demo``: one talking-face clip, neutral and emotional, on the
card; the flags of the reference demo (ref:demo.py:524-561).

    python -m eamm_tpu_torch.cli.demo --config configs/demo.yaml \\
        --checkpoint fomm.pth.tar --audio_checkpoint audio.pth.tar \\
        --emo_checkpoint emo.pth.tar --source_image img.png \\
        --driving_video emo.mp4 --pose_file pose.npy --in_file audio.wav \\
        --emotion happy

Counterpart of ``eamm_tpu/cli/demo.py``.  Writes neutral, emotion and the
three-panel ``all`` video into --result_path: mp4 through imageio where it
has a writer, else an uncompressed AVI with the audio muxed in
(``data/native.py``), else PNG frames and an .npy.  Runs on the CUDA device
unless ``--cpu`` is given; ``--smoke`` renders the checked-in kit
(``assets/demo/``) with random weights at ``configs/smoke.yaml``.

``main`` parses the flags, then calls ``build_pipeline(opt, config)``,
``load_inputs(opt)`` and ``run_demo(pipe, ...)``; the last two take and
give numpy arrays, so a caller without PyYAML or imageio can drive them.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np


def _str2bool(v):
    return str(v).lower() not in ("false", "0", "none", "")


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--smoke", action="store_true",
                        help="random weights (configs/smoke.yaml) over the "
                             "checked-in kit in assets/demo/; any flag "
                             "passed still wins")
    parser.add_argument("--config", default=None, help="path to config yaml")
    parser.add_argument("--checkpoint", default=None,
                        help="FOMM (generator+kp_detector) torch checkpoint")
    parser.add_argument("--audio_checkpoint", default=None,
                        help="audio (audio_feature+kp_detector_a) checkpoint")
    parser.add_argument("--emo_checkpoint", default=None,
                        help="emotion displacement checkpoint")
    parser.add_argument("--source_image", default=None,
                        help="an image file, or a [H, W, 3] .npy")
    parser.add_argument("--driving_video", default=None,
                        help="emotion-source video (required for --add_emo)")
    parser.add_argument("--in_file", default=None, help="driving audio")
    parser.add_argument("--pose_file", default=None, help="[N,7] pose npy")
    parser.add_argument("--pose_given", default=None,
                        help="long pose trajectory npy for --pose_long")
    parser.add_argument("--result_path", default="result/")
    parser.add_argument("--relative", action="store_true")
    parser.add_argument("--adapt_scale", action="store_true")
    parser.add_argument("--smooth_pose", type=_str2bool, default=True)
    parser.add_argument("--pose_long", type=_str2bool, default=False)
    parser.add_argument("--add_emo", type=_str2bool, default=True)
    parser.add_argument("--check_add", type=_str2bool, default=False)
    parser.add_argument("--type", default="linear_3", dest="emo_type")
    parser.add_argument("--emotion", default="disgusted",
                        choices=["angry", "contempt", "disgusted", "fear",
                                 "happy", "neutral", "sad", "surprised"])
    parser.add_argument("--weight", type=float, default=1.6,
                        help="audio feature exaggeration (ref hardcodes 1.6)")
    parser.add_argument("--kp_loss", default=0,
                        help="accepted for reference-CLI parity (unused "
                             "there too, ref:demo.py:549)")
    parser.add_argument("--no_crop", action="store_true",
                        help="source image is already aligned to 256x256")
    parser.add_argument("--no_align", action="store_true",
                        help="emotion video frames are already aligned "
                             "(skip the landmark-based per-frame alignment)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--transfer_format", default="rgb",
                        choices=["rgb", "yuv420"],
                        help="frames to the host as RGB uint8 or yuv420p "
                             "planes (half the bytes, a codec's loss)")
    parser.add_argument("--overlap_segments", type=int, default=1,
                        help="decode the clip in N segments, each copied to "
                             "the host while later ones decode (the same "
                             "frames; 1 = one segment)")
    parser.add_argument("--bf16", action="store_true",
                        help="run the generator decode in bfloat16 "
                             "(the keypoint path stays float32)")
    parser.add_argument("--segment_frames", type=int, default=0,
                        help="unbounded streaming: the clip in chunks of "
                             "this many frames, O(chunk) device memory; 0 = "
                             "the whole-clip route")
    parser.add_argument("--stream_policy_frames", type=int, default=384,
                        help="with --segment_frames: clips of at most this "
                             "many frames keep the whole-clip route; longer "
                             "ones chunk (0 = always chunk)")
    return parser


def smooth_pose_graft(pose_file: str, pose_long: str) -> np.ndarray:
    """Graft a long pose trajectory onto the source's start pose
    (ref:demo.py:456-465)."""
    start = np.load(pose_file).reshape(-1, 7)
    video_pose = np.load(pose_long).reshape(-1, 7)
    delta = video_pose - video_pose[0:1]
    return np.repeat(start[:1], len(delta), axis=0) + delta


def read_video(path: str) -> np.ndarray:
    """Frames [T, H, W, 3] float32 in [0, 1]: a .npy frame array (uint8
    scaled by 1/255), or a video through imageio."""
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        return arr[..., :3]
    import imageio.v2 as imageio
    reader = imageio.get_reader(path)
    frames = []
    try:
        for frame in reader:
            frames.append(np.asarray(frame, np.float32) / 255.0)
    except (RuntimeError, IndexError):
        pass
    reader.close()
    return np.array(frames)[..., :3]


def read_image(path: str) -> np.ndarray:
    """[H, W, 3] float32 in [0, 1]: a .npy array (uint8 scaled by 1/255)
    or an image file through imageio."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        import imageio.v2 as imageio
        img = imageio.imread(path)
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return np.asarray(img, np.float32)[..., :3]


def video_fps(path: str | None, default: float = 25.0) -> float:
    """fps of a video file; ``default`` for npy arrays and unreadable
    files.  The reference writes neutral/emotion at the driving video's
    fps (ref:demo.py:480,507,514)."""
    if not path or path.endswith(".npy"):
        return default
    try:
        import imageio.v2 as imageio
        reader = imageio.get_reader(path)
        fps = reader.get_meta_data().get("fps", default)
        reader.close()
        return float(fps)
    except Exception:
        return default


def write_video(path: str, frames_uint8: np.ndarray, fps: float = 25.0,
                audio=None) -> str:
    """mp4 through imageio where it has a writer (the audio is then remuxed
    by ``add_audio``); else an uncompressed AVI with the driving audio as a
    PCM stream (``data/native.py``); else PNG frames and an .npy.  Returns
    the path written."""
    try:
        import imageio.v2 as imageio
        imageio.mimsave(path, list(frames_uint8), fps=fps)
        return path
    except Exception:
        pass
    try:
        from eamm_tpu_torch.data.native import write_avi_rgb
        return write_avi_rgb(os.path.splitext(path)[0] + ".avi",
                             frames_uint8, fps=fps, audio=audio)
    except Exception:
        stem = os.path.splitext(path)[0]
        os.makedirs(stem, exist_ok=True)
        np.save(stem + ".npy", frames_uint8)
        import imageio.v2 as imageio
        for i, frame in enumerate(frames_uint8):
            imageio.imwrite(os.path.join(stem, f"{i}.png"), frame)
        return stem


def add_audio(video_path: str, audio_path: str):
    """ffmpeg remux (ref:demo.py:427-431); skipped without ffmpeg, for
    outputs that are not a file, and where the target would be the input."""
    import shutil
    import subprocess
    if shutil.which("ffmpeg") is None or not os.path.isfile(video_path):
        return
    out = os.path.splitext(video_path)[0] + ".mov"
    if os.path.abspath(out) == os.path.abspath(video_path):
        return
    subprocess.run(["ffmpeg", "-i", video_path, "-i", audio_path, "-vcodec",
                    "copy", "-acodec", "copy", "-y", out], check=False)


REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _apply_smoke_defaults(opt):
    """Fill unset flags from the checked-in kit (assets/demo/) and the
    smoke config; random weights when no checkpoints are given."""
    kit = os.path.join(REPO_ROOT, "assets", "demo")
    defaults = {
        "config": os.path.join(REPO_ROOT, "configs", "smoke.yaml"),
        "source_image": os.path.join(kit, "portrait.png"),
        "in_file": os.path.join(kit, "speech.wav"),
        "pose_file": os.path.join(kit, "pose.npy"),
        "driving_video": os.path.join(kit, "emotion_clip.npy"),
    }
    for key, value in defaults.items():
        if getattr(opt, key) is None:
            setattr(opt, key, value)
    # the kit's emotion clip is synthetic and its portrait 256x256
    opt.no_crop = True
    opt.no_align = True
    return opt


def pipeline_options(opt):
    """The parsed flags -> ``PipelineOptions``."""
    import torch

    from eamm_tpu_torch.infer import PipelineOptions
    return PipelineOptions(relative=opt.relative,
                           adapt_scale=opt.adapt_scale,
                           add_emo=opt.add_emo, emo_type=opt.emo_type,
                           audio_weight=opt.weight,
                           smooth_pose=opt.smooth_pose,
                           check_add=opt.check_add,
                           transfer_format=opt.transfer_format,
                           overlap_segments=max(1, opt.overlap_segments),
                           segment_frames=opt.segment_frames or None,
                           stream_policy_frames=(
                               opt.stream_policy_frames or None),
                           compute_dtype=(torch.bfloat16 if opt.bf16
                                          else torch.float32),
                           device="cpu" if opt.cpu else "cuda")


def build_pipeline(opt, config: dict):
    """The parsed flags and the config dict -> the ``EammPipeline``: random
    weights without --checkpoint (``--smoke``), else the three checkpoints,
    each first checked by the preflight (a missing key exits with the
    whole report; unused keys are printed)."""
    from eamm_tpu_torch.infer import EammPipeline
    options = pipeline_options(opt)
    if opt.checkpoint is None:
        return EammPipeline.from_random(config, options=options)
    from eamm_tpu_torch.compat.preflight import check_state_dict
    for path in (opt.checkpoint, opt.audio_checkpoint, opt.emo_checkpoint):
        report = check_state_dict(path)
        if report.fatal:
            raise SystemExit(str(report))
        if not report.ok:
            print(report)
    return EammPipeline.from_torch_checkpoints(
        config, opt.checkpoint, opt.audio_checkpoint, opt.emo_checkpoint,
        options)


def load_inputs(opt):
    """The files the flags name -> (source [256,256,3] float32 in [0, 1],
    cropped unless --no_crop; waveform [N] float32 at 16 kHz; pose [M, 7];
    driving frames [U, H, W, 3] float32, or None without --add_emo)."""
    from eamm_tpu_torch.data.preprocess import crop_image, load_audio
    src = read_image(opt.source_image)
    if not opt.no_crop:
        src = crop_image(src)
    if src.shape[:2] != (256, 256):
        raise SystemExit("source image must be 256x256 (use alignment crop)")
    all_pose = np.load(opt.pose_file).reshape(-1, 7)
    if opt.pose_long:
        all_pose = smooth_pose_graft(opt.pose_file, opt.pose_given)
    waveform = load_audio(opt.in_file)
    driving = None
    if opt.add_emo:
        if not opt.driving_video:
            raise SystemExit("--add_emo requires --driving_video")
        driving = read_video(opt.driving_video)
    return src, waveform, all_pose, driving


def emotion_input(driving: np.ndarray, opt, config: dict) -> tuple:
    """Driving frames -> (the frames aligned to frame 0's landmarks unless
    --no_align, the template shifted [0, -10] for surprised and fear,
    ref:demo.py:159-160; those frames through the config's
    ``dataset_params.augmentation_params``, drawn from numpy's and Python's
    global random streams: the mouth-masked emotion frames the render
    reads)."""
    from eamm_tpu_torch.data.augmentation import AllAugmentationTransform
    from eamm_tpu_torch.data.preprocess import align_clip
    if not opt.no_align:
        shift = (0, 10) if opt.emotion in ("surprised", "fear") else (0, 0)
        driving = align_clip(driving, shift=shift)
    aug = AllAugmentationTransform(
        **config["dataset_params"]["augmentation_params"])
    return driving, np.asarray(aug(driving))


def run_demo(pipe, src, waveform, all_pose, driving, opt,
             config: dict) -> dict:
    """The neutral and, with --add_emo, the emotional render and the
    three-panel clip (ref:demo.py:504-514), written into --result_path ->
    {'neutral', 'emotion', 'all': uint8 frames, 'transformed': the emotion
    frames rendered, 'movement_scale': adapt_scale's, or None}."""
    os.makedirs(opt.result_path, exist_ok=True)
    # neutral and emotion play at the driving video's fps, all at 25
    # (ref:demo.py:480,507,514,425)
    out_fps = video_fps(opt.driving_video)
    neutral = pipe.render_uint8(src, waveform, all_pose, add_emo=False)
    write_video(os.path.join(opt.result_path, "neutral.mp4"), neutral,
                fps=out_fps)
    outputs = {"neutral": neutral}
    if opt.add_emo:
        driving, transformed = emotion_input(driving, opt, config)
        emotion = pipe.render_uint8(src, waveform, all_pose,
                                    transformed_video=transformed,
                                    add_emo=True)
        path = write_video(os.path.join(opt.result_path, "emotion.mp4"),
                           emotion, fps=out_fps, audio=(waveform, 16000))
        if opt.in_file:
            add_audio(path, opt.in_file)
        T = len(emotion)
        drv = np.resize(driving, (T,) + driving.shape[1:])
        drv8 = np.clip(np.round(drv * 255), 0, 255).astype(np.uint8)
        allv = np.concatenate([drv8, np.resize(neutral, emotion.shape),
                               emotion], axis=2)
        all_path = write_video(os.path.join(opt.result_path, "all.mp4"),
                               allv, fps=25.0, audio=(waveform, 16000))
        if opt.in_file:
            add_audio(all_path, opt.in_file)
        outputs.update(emotion=emotion, all=allv, transformed=transformed)
    print({k: v.shape for k, v in outputs.items()})
    outputs["movement_scale"] = (pipe.last_movement_scale
                                 if opt.adapt_scale else None)
    return outputs


def main(argv=None) -> dict:
    opt = build_parser().parse_args(argv)
    if opt.smoke:
        opt = _apply_smoke_defaults(opt)
    else:
        missing = [f for f in ("config", "checkpoint", "audio_checkpoint",
                               "emo_checkpoint", "source_image", "in_file",
                               "pose_file") if getattr(opt, f) is None]
        if missing:
            raise SystemExit(
                "missing required arguments: "
                + ", ".join(f"--{m}" for m in missing)
                + " (or pass --smoke for the self-contained demo)")
    from eamm_tpu_torch.config import load_config
    config = load_config(opt.config)
    pipe = build_pipeline(opt, config)
    return run_demo(pipe, *load_inputs(opt), opt, config)


if __name__ == "__main__":
    main()
