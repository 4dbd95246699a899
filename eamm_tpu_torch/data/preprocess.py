"""Host-side preprocessing for the demo: face crop and alignment, audio
decode.

Counterpart of ``eamm_tpu/data/preprocess.py`` (its pose estimate and MFCC
export, which serve ``cli/preprocess``, are not ported).  Parity targets
(ref:process_data.py, ref:demo.py:43-44,146-190,433-454):

- ``crop_image``: 68 facial landmarks -> similarity transform (Umeyama) to
  the M003 template's first 47 points -> warp to 256x256.
- ``align_clip``: estimate the transform on frame 0 (or per frame) and warp
  every frame (``crop_image_tem`` / ``get_aligned_image``).
- ``load_audio``: 16 kHz mono waveform (wav via scipy; other containers via
  ffmpeg when available).

Landmark detection is pluggable: dlib is used when importable (it is a C++
dependency of the reference, not present in every image); otherwise pass
``landmarks=`` explicitly.  All warping math is self-contained numpy.
"""
from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from eamm_tpu_torch.data.augmentation import _bilinear_sample


def similarity_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Umeyama least-squares similarity (rotation+scale+translation) mapping
    src -> dst; returns a 3x3 matrix (skimage SimilarityTransform.estimate
    equivalent)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    src_c = src - mu_s
    dst_c = dst - mu_d
    cov = dst_c.T @ src_c / len(src)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    D = np.diag([1.0, d])
    R = U @ D @ Vt
    var_s = (src_c ** 2).sum() / len(src)
    scale = np.trace(np.diag(S) @ D) / var_s
    t = mu_d - scale * R @ mu_s
    M = np.eye(3)
    M[:2, :2] = scale * R
    M[:2, 2] = t
    return M


def warp_to_template(image: np.ndarray, tform: np.ndarray,
                     out_shape=(256, 256)) -> np.ndarray:
    """skimage ``tf.warp(image, tform)`` semantics: tform maps OUTPUT
    coordinates to input coordinates (the reference estimates template ->
    image landmarks, ref:demo.py:448-451), bilinear, zero border."""
    h, w = out_shape
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    sx = tform[0, 0] * xs + tform[0, 1] * ys + tform[0, 2]
    sy = tform[1, 0] * xs + tform[1, 1] * ys + tform[1, 2]
    return _bilinear_sample(np.asarray(image, np.float64), sx, sy,
                            "constant").astype(np.float32)


def _detect_landmarks_dlib(image_uint8: np.ndarray) -> np.ndarray | None:
    """68-point landmarks via dlib when available, else None."""
    try:
        import dlib
    except ImportError:
        return None
    detector = dlib.get_frontal_face_detector()
    pred_path = os.environ.get("DLIB_SHAPE_PREDICTOR",
                               "shape_predictor_68_face_landmarks.dat")
    if not os.path.exists(pred_path):
        return None
    predictor = dlib.shape_predictor(pred_path)
    gray = (np.asarray(image_uint8)[..., :3]
            @ np.array([0.299, 0.587, 0.114])).astype(np.uint8)
    rects = detector(gray, 1)
    if len(rects) != 1:
        return None
    shape = predictor(gray, rects[0])
    return np.array([[shape.part(i).x, shape.part(i).y] for i in range(68)])


def detect_landmarks(image_uint8: np.ndarray,
                     allow_coarse: bool = True) -> np.ndarray | None:
    """68-point landmarks: dlib when importable (the reference's detector,
    ref:process_data.py:21-22), otherwise the self-contained coarse
    skin-blob aligner (``data/landmarks.py``: framing-level accuracy,
    enough for the similarity-warp crop), otherwise a centered-portrait
    prior.  ``allow_coarse=False`` restores dlib-or-None."""
    lm = _detect_landmarks_dlib(image_uint8)
    if lm is not None or not allow_coarse:
        return lm
    from eamm_tpu_torch.data.landmarks import (center_prior_landmarks,
                                               estimate_landmarks_coarse)
    template = load_template()
    lm = estimate_landmarks_coarse(np.asarray(image_uint8), template)
    if lm is None:
        lm = center_prior_landmarks(np.asarray(image_uint8).shape, template)
    return lm


def load_template(path: str | None = None) -> np.ndarray:
    """The M003 68x2 landmark template (ref:M003_template.npy), from the
    repository's ``assets/``."""
    if path is None:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), "assets",
            "M003_template.npy")
    return np.load(path)


def crop_image(image: np.ndarray, landmarks: np.ndarray | None = None,
               template: np.ndarray | None = None,
               n_points: int = 47) -> np.ndarray:
    """Align a face image to the template (ref:demo.py:433-454).

    image: [H, W, 3] float in [0,1] or uint8.  Returns [256, 256, 3] float32.
    """
    img = np.asarray(image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if landmarks is None:
        landmarks = detect_landmarks((img * 255).astype(np.uint8))
        if landmarks is None:
            raise RuntimeError(
                "no landmark backend available — install dlib + shape "
                "predictor or pass landmarks= explicitly")
    template = load_template() if template is None else template
    tform = similarity_transform(template[:n_points], landmarks[:n_points])
    return warp_to_template(img, tform)


def align_clip(frames: np.ndarray, landmarks0: np.ndarray | None = None,
               per_frame_landmarks=None, template: np.ndarray | None = None,
               n_points: int = 35, shift=(0, 0)) -> np.ndarray:
    """Align every frame of an emotion-source clip.

    Default reproduces ``get_aligned_image`` (ref:demo.py:146-182): the
    frame-0 landmarks are the template (optionally shifted [0,-10] for
    surprised/fear), each frame warped by its own landmarks' similarity fit.
    With ``per_frame_landmarks=None`` the frame-0 transform is reused
    (``crop_image_tem`` behavior, ref:process_data.py:85-122).
    """
    frames = np.asarray(frames)
    if landmarks0 is None:
        landmarks0 = detect_landmarks((frames[0] * 255).astype(np.uint8))
        if landmarks0 is None:
            raise RuntimeError("no landmarks for frame 0")
    tmpl = (np.asarray(landmarks0) - np.asarray(shift))[:n_points]
    out = []
    for i, frame in enumerate(frames):
        if per_frame_landmarks is not None:
            lm = np.asarray(per_frame_landmarks[i])[:n_points]
        else:
            lm = detect_landmarks((frame * 255).astype(np.uint8))
            lm = tmpl if lm is None else lm[:n_points]
        tform = similarity_transform(tmpl, lm)
        out.append(warp_to_template(frame, tform))
    return np.array(out)


def load_audio(path: str, sr: int = 16000) -> np.ndarray:
    """Mono float waveform at ``sr``.  wav via scipy; anything else through
    ffmpeg (subprocess, as the reference does — ref:process_data.py:124-127)."""
    if path.lower().endswith(".wav"):
        from scipy.io import wavfile
        from scipy.signal import resample_poly
        rate, data = wavfile.read(path)
        if data.dtype.kind == "i":
            data = data.astype(np.float32) / np.iinfo(data.dtype).max
        elif data.dtype.kind == "u":
            data = (data.astype(np.float32) - 128) / 128.0
        if data.ndim == 2:
            data = data.mean(axis=1)
        if rate != sr:
            from math import gcd
            g = gcd(rate, sr)
            data = resample_poly(data, sr // g, rate // g)
        return data.astype(np.float32)
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(f"ffmpeg not available to decode {path!r}; "
                           "provide a 16 kHz wav instead")
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
        subprocess.run(["ffmpeg", "-i", path, "-loglevel", "error", "-y",
                        "-f", "wav", "-acodec", "pcm_s16le", "-ar", str(sr),
                        tmp.name], check=True)
        return load_audio(tmp.name, sr)


