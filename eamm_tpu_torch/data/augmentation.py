"""Host-side (numpy) clip augmentation: the demo's mouth-masked emotion
frames.

Counterpart of ``eamm_tpu/data/augmentation.py``, the same frames for the
same ``random`` and ``numpy.random`` seeds: the reference's pipeline
(ref:augmentation.py) without cv2, skimage or PIL; a shared bilinear
homography warp stands in for ``skimage.transform.rotate`` and
``cv2.warpPerspective``.

Fixed composition order matches AllAugmentationTransform
(ref:augmentation.py:404-430): MouthCrop -> RandomFlip -> RandomRotation ->
RandomPerspective -> RandomResize -> RandomCrop -> ColorJitter.  Clips are
[T, H, W, 3] float arrays in [0, 1].
"""
from __future__ import annotations

import numbers
import random

import numpy as np


def _bilinear_sample(img: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                     border: str = "constant") -> np.ndarray:
    """Sample img [H,W,C] at float coords (xs, ys) [h,w] -> [h,w,C]."""
    H, W = img.shape[:2]
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    wx = (xs - x0)[..., None]
    wy = (ys - y0)[..., None]

    def gather(xi, yi):
        xc = np.clip(xi, 0, W - 1)
        yc = np.clip(yi, 0, H - 1)
        val = img[yc, xc]
        if border == "constant":
            inside = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))[..., None]
            val = np.where(inside, val, 0.0)
        return val

    return ((1 - wx) * (1 - wy) * gather(x0, y0)
            + wx * (1 - wy) * gather(x0 + 1, y0)
            + (1 - wx) * wy * gather(x0, y0 + 1)
            + wx * wy * gather(x0 + 1, y0 + 1))


def warp_homography(img: np.ndarray, M: np.ndarray,
                    out_shape: tuple[int, int],
                    border: str = "constant") -> np.ndarray:
    """Warp img by 3x3 homography M (dst -> src uses M^-1, cv2 convention:
    dst(x, y) = src(M^-1 [x, y, 1]))."""
    h, w = out_shape
    Minv = np.linalg.inv(M)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    denom = Minv[2, 0] * xs + Minv[2, 1] * ys + Minv[2, 2]
    sx = (Minv[0, 0] * xs + Minv[0, 1] * ys + Minv[0, 2]) / denom
    sy = (Minv[1, 0] * xs + Minv[1, 1] * ys + Minv[1, 2]) / denom
    return _bilinear_sample(img, sx, sy, border)


def perspective_matrix(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3x3 homography mapping 4 src points to 4 dst points
    (cv2.getPerspectiveTransform equivalent, DLT solve)."""
    A, b = [], []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b.append(u)
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.append(v)
    h = np.linalg.solve(np.asarray(A, np.float64), np.asarray(b, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


class MouthCrop:
    """Fill a fixed mouth rectangle with uniform noise — hides the mouth
    from the emotion branch (ref:augmentation.py:175-213; MEAD config
    center (135, 190), 100x60)."""

    def __init__(self, center_x, center_y, mask_width, mask_height):
        self.center_x, self.center_y = center_x, center_y
        self.mask_width, self.mask_height = mask_width, mask_height

    @property
    def rect(self):
        """(y0, x0) of the masked rectangle."""
        return (self.center_y - self.mask_height // 2,
                self.center_x - self.mask_width // 2)

    def sample_noise(self, num_frames):
        """The per-frame noise blocks.  One vectorized draw: MT19937 fills
        the output in C order, so this consumes the stream exactly like
        ``num_frames`` sequential ``rand(h, w, 3)`` calls."""
        return np.random.rand(num_frames, self.mask_height,
                              self.mask_width, 3)

    def __call__(self, clip):
        y0, x0 = self.rect
        noise = self.sample_noise(len(clip))
        out = np.array(clip, copy=True)
        out[:, y0:y0 + self.mask_height, x0:x0 + self.mask_width, :] = noise
        return out


class RandomFlip:
    def __init__(self, time_flip=False, horizontal_flip=False):
        self.time_flip = time_flip
        self.horizontal_flip = horizontal_flip

    def __call__(self, clip):
        if random.random() < 0.5 and self.time_flip:
            return clip[::-1]
        if random.random() < 0.5 and self.horizontal_flip:
            return np.array([np.fliplr(img) for img in clip])
        return clip


class RandomRotation:
    """One angle per clip, rotation about the image center, bilinear,
    constant-zero border (skimage.transform.rotate semantics,
    ref:augmentation.py:216-251)."""

    def __init__(self, degrees):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees

    def sample_matrix(self, h, w):
        """Draw one clip rotation and return its 3x3 homography."""
        angle = random.uniform(*self.degrees)
        theta = np.deg2rad(angle)
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        # skimage rotate: counter-clockwise in image coordinates
        c, s = np.cos(theta), np.sin(theta)
        return np.array([[c, -s, cx - c * cx + s * cy],
                         [s, c, cy - s * cx - c * cy],
                         [0, 0, 1]])

    def __call__(self, clip):
        h, w = clip[0].shape[:2]
        M = self.sample_matrix(h, w)
        return np.array([warp_homography(img, M, (h, w), "constant")
                         for img in clip])


class RandomPerspective:
    """Per-frame random 4-point perspective with replicate border
    (ref:augmentation.py:253-292; MEAD config pers_num 30, enlarge_num 40)."""

    def __init__(self, pers_num, enlarge_num):
        self.pers_num = pers_num
        self.enlarge_num = enlarge_num

    def sample_matrix(self, h, w):
        """Draw one frame's perspective params and return the homography
        (__call__'s exact np.random order)."""
        pers = np.random.randint(20, self.pers_num) * (-1) ** np.random.randint(2)
        enl = np.random.randint(20, self.enlarge_num) * (-1) ** np.random.randint(2)
        src = np.array([[-enl, -enl], [-enl, w + enl],
                        [h + enl, -enl], [h + enl, w + enl]], np.float64)
        dst = np.array([[-enl, -enl], [-enl + pers, w + enl],
                        [h + enl, -enl], [h + enl - pers, w + enl]],
                       np.float64)
        return perspective_matrix(src, dst)

    def __call__(self, clip):
        out = []
        for img in clip:
            M = self.sample_matrix(*img.shape[:2])
            out.append(warp_homography(img, M, (256, 256), "replicate"))
        return np.array(out)


class RandomResize:
    def __init__(self, ratio=(3. / 4., 4. / 3.), interpolation="nearest"):
        self.ratio = ratio

    def __call__(self, clip):
        factor = random.uniform(*self.ratio)
        h, w = clip[0].shape[:2]
        nh, nw = int(h * factor), int(w * factor)
        ys = np.clip((np.arange(nh) / factor).astype(np.int64), 0, h - 1)
        xs = np.clip((np.arange(nw) / factor).astype(np.int64), 0, w - 1)
        return np.array([img[ys][:, xs] for img in clip])


class RandomCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, numbers.Number) else size

    def __call__(self, clip):
        h, w = self.size
        im_h, im_w = clip[0].shape[:2]
        pad_h = max(0, h - im_h)
        pad_w = max(0, w - im_w)
        if pad_h or pad_w:
            clip = np.pad(np.asarray(clip),
                          ((0, 0), (pad_h // 2, (pad_h + 1) // 2),
                           (pad_w // 2, (pad_w + 1) // 2), (0, 0)),
                          mode="edge")
            im_h, im_w = clip[0].shape[:2]
        x1 = 0 if im_w == w else random.randint(0, im_w - w)
        y1 = 0 if im_h == h else random.randint(0, im_h - h)
        return np.asarray(clip)[:, y1:y1 + h, x1:x1 + w]


class ColorJitter:
    """Brightness/contrast/saturation/hue jitter with one factor per clip
    (torchvision-style factor ranges, ref:augmentation.py:295-403)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def sample_factors(self):
        """One (b, c, s, hue) tuple per clip; disabled channels sample the
        identity (b=c=s=1, hue=0)."""
        b = random.uniform(max(0, 1 - self.brightness), 1 + self.brightness) \
            if self.brightness > 0 else 1.0
        c = random.uniform(max(0, 1 - self.contrast), 1 + self.contrast) \
            if self.contrast > 0 else 1.0
        s = random.uniform(max(0, 1 - self.saturation), 1 + self.saturation) \
            if self.saturation > 0 else 1.0
        hshift = random.uniform(-self.hue, self.hue) if self.hue > 0 else 0.0
        return b, c, s, hshift

    @staticmethod
    def apply_factors(clip, b, c, s, hshift):
        """Apply one factor tuple to a [T, H, W, 3] clip."""
        out = []
        for img in clip:
            x = np.asarray(img, np.float64)
            x = x * b
            mean = x.mean(axis=(0, 1), keepdims=True).mean()
            x = (x - mean) * c + mean
            gray = x @ np.array([0.299, 0.587, 0.114])
            x = (x - gray[..., None]) * s + gray[..., None]
            if hshift != 0.0:
                x = _shift_hue(x, hshift)
            out.append(np.clip(x, 0, 1).astype(np.float32))
        return np.array(out)

    def __call__(self, clip):
        return self.apply_factors(clip, *self.sample_factors())


def _shift_hue(rgb: np.ndarray, shift: float) -> np.ndarray:
    """Rotate hue by ``shift`` (fraction of a full turn) via YIQ rotation."""
    theta = 2 * np.pi * shift
    c, s = np.cos(theta), np.sin(theta)
    to_yiq = np.array([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.322],
                       [0.211, -0.523, 0.312]])
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    m = np.linalg.inv(to_yiq) @ rot @ to_yiq
    return rgb @ m.T


class AllAugmentationTransform:
    """Fixed-order composition (ref:augmentation.py:408-430)."""

    def __init__(self, crop_mouth_param=None, resize_param=None,
                 rotation_param=None, perspective_param=None, flip_param=None,
                 crop_param=None, jitter_param=None):
        self.transforms = []
        if crop_mouth_param is not None:
            self.transforms.append(MouthCrop(**crop_mouth_param))
        if flip_param is not None:
            self.transforms.append(RandomFlip(**flip_param))
        if rotation_param is not None:
            self.transforms.append(RandomRotation(**rotation_param))
        if perspective_param is not None:
            self.transforms.append(RandomPerspective(**perspective_param))
        if resize_param is not None:
            self.transforms.append(RandomResize(**resize_param))
        if crop_param is not None:
            self.transforms.append(RandomCrop(**crop_param))
        if jitter_param is not None:
            self.transforms.append(ColorJitter(**jitter_param))

    def __call__(self, clip):
        for t in self.transforms:
            clip = t(clip)
        return clip
