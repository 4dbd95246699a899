"""Training and evaluation datasets, repeater and loader (NHWC numpy).

The port's copy of ``eamm_tpu/data/datasets.py``:

- **LRW / AudioDataset**: ``Image/{train_fo,test_fo}/<word>/<clip>/<N>.png``,
  ``MFCC/{train,test}/<word>/<clip>/<N>.npy`` ([28, 13] windows),
  ``pose/{train_fo,test_fo}/<word>/<clip>.npy`` ([M, 7]); a sample holds
  example_image [256,256,3], driving [16,256,256,3], driving_audio
  [16,28,12] and driving_pose [16,6], float32, or with
  ``device_augmentation`` uint8 frames and the per-clip flip and jitter
  decisions (``ops/augment.py`` applies them on the device);
- **Vox / VoxDataset**: ``align_img/...``, per-video ``MFCC/<name>.npy``
  ([M, 28, 13]) and ``align_pose/<name>.npy``, the same sample;
- **MEAD / MeadDataset** (part2): ``MEAD_fomm_crop/<id>/<clip>/<N>.png``,
  ``MEAD_MFCC/<id>/<clip>.npy``, ``MEAD_fomm_pose_crop/<id>/<clip>.npy``;
  the example image is a random frame of a random *neutral* clip of the
  same identity, the pose is one-euro smoothed, and the sample adds the
  integer ``emotion`` label (from the clip name, ``EMOTIONS``) and
  ``transformed_driving``, the window through the mouth mask, flip,
  rotation, perspective and jitter: on the host, or with
  ``device_augmentation`` as uint8 frames and ``tdrv_*`` decisions that
  ``ops/augment.py`` applies on the device;
- ``PairedDataset`` (source / driving pairs for ``animate``),
  ``DatasetRepeater`` (epoch lengthening) and ``DataLoader`` (a thread
  pool decoding samples, a bounded queue of prefetched batches).

Frames come from a ``frames.eammpack`` next to the PNGs when there is one
(``data/packed.py``), else from the PNGs through the libpng batch decoder
(``data/native.py``; imageio where it cannot be built).  The host draws from
Python's ``random`` and numpy's global state in the JAX package's order,
so the same seeds give the same sample in both packages.
"""
from __future__ import annotations

import os
import queue
import random
import threading

import numpy as np

from eamm_tpu_torch.data.augmentation import AllAugmentationTransform
from eamm_tpu_torch.ops.filters import one_euro_filter_np

# the demo's emotion vocabulary, in its documented order
EMOTIONS = ("angry", "contempt", "disgusted", "fear", "happy", "neutral",
            "sad", "surprised")


def _png_size(path: str) -> tuple[int, int]:
    """(h, w) from the PNG IHDR without decoding."""
    with open(path, "rb") as f:
        head = f.read(24)
    w = int.from_bytes(head[16:20], "big")
    h = int.from_bytes(head[20:24], "big")
    return h, w


def _read_frames(paths: list[str], hw=None, uint8: bool = False) -> np.ndarray:
    """Window frame load: a ``frames.eammpack`` file next to the requested
    PNGs (``data/packed.py``) is served as a decode-free memmap slice;
    everything else is decoded by ``native.decode_batch``.  hw=None
    loads at the files' own resolution (reference semantics: clips are
    pre-cropped, never resized at load time).  uint8=True serves raw bytes
    (the device-augmentation upload format — a pure copy on the packed
    path; exact either way since PNGs store uint8)."""
    from eamm_tpu_torch.data import native, packed

    dtype = np.uint8 if uint8 else np.float32

    def from_f32(f):
        if not uint8:
            return f
        return np.clip(np.rint(f * 255.0), 0, 255).astype(np.uint8)

    by_dir: dict[str, list[int]] = {}
    for i, p in enumerate(paths):
        by_dir.setdefault(os.path.dirname(p), []).append(i)
    packs = {d: packed.find_pack(d) for d in by_dir}

    if not any(packs.values()):
        if hw is None:
            hw = _png_size(paths[0])
        return from_f32(native.decode_batch(paths, hw[0], hw[1]))

    if hw is None:
        d0 = os.path.dirname(paths[0])
        hw = (packed.frame_size(packs[d0]) if packs[d0]
              else _png_size(paths[0]))
    out = np.empty((len(paths), hw[0], hw[1], 3), dtype)
    png_rows: list[int] = []
    for d, rows in by_dir.items():
        pack_path = packs[d]
        if pack_path is None:
            png_rows.extend(rows)
            continue
        ids = [int(os.path.basename(paths[i])[:-len(".png")]) for i in rows]
        frames = packed.read_frames(pack_path, ids, dtype=dtype)
        if frames.shape[1:3] != tuple(hw):
            raise IOError(
                f"{pack_path}: packed size {frames.shape[1:3]} != "
                f"window size {tuple(hw)}")
        out[rows] = frames[..., :3]
    if png_rows:
        out[png_rows] = from_f32(native.decode_batch(
            [paths[i] for i in png_rows], hw[0], hw[1]))
    return out


def _discover_clips(image_dir: str) -> list[str]:
    """All '<sub>/<clip>' directories two levels below image_dir."""
    clips = []
    for sub in sorted(os.listdir(image_dir)):
        sub_path = os.path.join(image_dir, sub)
        if not os.path.isdir(sub_path):
            continue
        for clip in sorted(os.listdir(sub_path)):
            if os.path.isdir(os.path.join(sub_path, clip)):
                clips.append(f"{sub}/{clip}")
    return clips


def _video_list(video_list, image_dir: str) -> list:
    """An explicit list (or a ``.npy`` of one), else every clip on disk."""
    if video_list is None:
        return _discover_clips(image_dir)
    return (list(np.load(video_list)) if isinstance(video_list, str)
            else list(video_list))


def _make_device_aug(augmentation_params):
    """Validate + build the host-side SAMPLERS for device augmentation:
    the per-clip flip coins and jitter factors are drawn on the host (the
    reference's RNG semantics, ref:augmentation.py:408-430 order), the
    per-pixel work runs inside the jitted train step
    (``ops/augment.py`` ``decode_and_augment``).  Only flip + jitter are
    device-expressible; geometric augmentations (MEAD part-2 pipeline)
    stay on the host."""
    from eamm_tpu_torch.data.augmentation import ColorJitter, RandomFlip
    ap = augmentation_params or {}
    extra = {k for k, v in ap.items() if v is not None} \
        - {"flip_param", "jitter_param"}
    if extra:
        raise ValueError(
            "device_augmentation supports flip_param/jitter_param only; "
            f"config also has {sorted(extra)}")
    return (RandomFlip(**ap["flip_param"])
            if ap.get("flip_param") is not None else None,
            ColorJitter(**ap["jitter_param"])
            if ap.get("jitter_param") is not None else None)


def _sample_device_aug(flip, jitter):
    """Draw per-clip augmentation decisions in the host pipeline's exact
    coin order: time-flip coin, then (only if not taken) horizontal coin,
    then the jitter factors.  An absent transform (None sampler, matching
    AllAugmentationTransform's `is not None` construction) consumes zero
    draws so the stream stays aligned with a seeded host run."""
    out = {}
    if flip is not None:
        ft = 1 if (random.random() < 0.5 and flip.time_flip) else 0
        fh = 0
        if not ft:
            fh = 1 if (random.random() < 0.5 and flip.horizontal_flip) else 0
        out["flip_time"] = np.uint8(ft)
        out["flip_h"] = np.uint8(fh)
    if jitter is not None:
        out["jitter_factors"] = np.asarray(jitter.sample_factors(),
                                           np.float32)
    return out


def _make_mead_device_aug(augmentation_params) -> dict:
    """The samplers of the device MEAD pipeline: mouth mask, flip,
    rotation, perspective and jitter (the MEAD config's set); resize and
    crop are refused.  A sampler exists exactly where the host pipeline
    would build the transform (its parameters not None), so an absent one
    draws nothing and the random stream stays the host run's."""
    from eamm_tpu_torch.data.augmentation import (ColorJitter, MouthCrop,
                                                  RandomFlip,
                                                  RandomPerspective,
                                                  RandomRotation)
    ap = augmentation_params or {}
    supported = {"crop_mouth_param", "flip_param", "rotation_param",
                 "perspective_param", "jitter_param"}
    extra = {k for k, v in ap.items() if v is not None} - supported
    if extra:
        raise ValueError(
            "device_augmentation (MEAD) supports mouth/flip/rotation/"
            f"perspective/jitter only; config also has {sorted(extra)}")

    def opt(key, cls):
        return cls(**ap[key]) if ap.get(key) is not None else None

    return {"mouth": opt("crop_mouth_param", MouthCrop),
            "flip": opt("flip_param", RandomFlip),
            "rot": opt("rotation_param", RandomRotation),
            "pers": opt("perspective_param", RandomPerspective),
            "jitter": opt("jitter_param", ColorJitter)}


def _sample_mead_device_aug(samplers: dict, num_frames: int, h: int,
                            w: int) -> dict:
    """One clip's ``tdrv_*`` decisions, drawn in AllAugmentationTransform's
    order (mouth noise, flip coins, rotation angle, a perspective per
    frame, jitter factors); the matrices inverted on the host in float64,
    then float32."""
    keys = {}
    mouth = samplers["mouth"]
    if mouth is not None:
        noise = mouth.sample_noise(num_frames)
        keys["tdrv_mouth_noise"] = np.clip(np.rint(noise * 255.0), 0,
                                           255).astype(np.uint8)
        keys["tdrv_mouth_rect"] = np.asarray(mouth.rect, np.int32)
    flip = samplers["flip"]
    if flip is not None:
        ft = 1 if (random.random() < 0.5 and flip.time_flip) else 0
        fh = 0
        if not ft:
            fh = 1 if (random.random() < 0.5 and flip.horizontal_flip) else 0
        keys["tdrv_flip_time"] = np.uint8(ft)
        keys["tdrv_flip_h"] = np.uint8(fh)
    if samplers["rot"] is not None:
        keys["tdrv_rot_minv"] = np.linalg.inv(
            samplers["rot"].sample_matrix(h, w)).astype(np.float32)
    if samplers["pers"] is not None:
        keys["tdrv_pers_minv"] = np.asarray(
            [np.linalg.inv(samplers["pers"].sample_matrix(h, w))
             for _ in range(num_frames)], np.float32)
    if samplers["jitter"] is not None:
        keys["tdrv_jitter"] = np.asarray(samplers["jitter"].sample_factors(),
                                         np.float32)
    return keys


def _window(mfcc, pose, r: int) -> tuple:
    """The 16-step window after start ``r``: (mfcc [16, 28, 12], pose
    [16, 6]) from per-step arrays."""
    return (np.array([mfcc[r + i][:, 1:] for i in range(1, 17)], np.float32),
            np.array([pose[r + i, :-1] for i in range(1, 17)], np.float32))


class AudioDataset:
    """LRW-layout dataset (ref:frames_dataset.py:75-194)."""

    def __init__(self, root_dir, frame_shape=(256, 256, 3), id_sampling=False,
                 is_train=True, random_seed=0, augmentation_params=None,
                 video_list=None, name=None, device_augmentation=False):
        split_img = "train_fo" if is_train else "test_fo"
        split_audio = "train" if is_train else "test"
        self.image_dir = os.path.join(root_dir, "Image", split_img)
        self.audio_dir = os.path.join(root_dir, "MFCC", split_audio)
        self.pose_dir = os.path.join(root_dir, "pose", split_img)
        self.videos = _video_list(video_list, self.image_dir)
        self.is_train = is_train
        self.frame_hw = tuple(frame_shape[:2])
        self.device_aug = bool(device_augmentation) and is_train
        if self.device_aug:
            self.dev_samplers = _make_device_aug(augmentation_params)
            self.transform = None
        else:
            self.transform = (
                AllAugmentationTransform(**(augmentation_params or {}))
                if is_train else None)

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, idx):
        name = str(self.videos[idx]).split(".")[0]
        path = os.path.join(self.image_dir, name)
        audio_path = os.path.join(self.audio_dir, name)
        # window start r in [3, 7] (ref:frames_dataset.py:152)
        r = random.choice(range(3, 8))
        pose_all = np.load(os.path.join(self.pose_dir, name + ".npy"))

        mfccs, poses = [], []
        for ind in range(1, 17):
            mfccs.append(np.load(os.path.join(audio_path, f"{r + ind}.npy"),
                                 allow_pickle=True)[:, 1:])
            poses.append(pose_all[r + ind, :-1])
        decoded = _read_frames(
            [os.path.join(path, f"{r + ind}.png") for ind in range(0, 17)],
            hw=None, uint8=self.device_aug)
        example_image, video_array = decoded[0], decoded[1:]
        if self.transform is not None:
            video_array = np.asarray(self.transform(video_array))
        sample = {
            "example_image": example_image if self.device_aug
            else example_image.astype(np.float32),
            "driving": video_array if self.device_aug
            else video_array.astype(np.float32),
            "driving_audio": np.array(mfccs, np.float32),
            "driving_pose": np.array(poses, np.float32),
        }
        if self.device_aug:
            sample.update(_sample_device_aug(*self.dev_samplers))
        return sample


class VoxDataset:
    """VoxCeleb-layout dataset (``align_img``, per-video MFCC and pose)."""

    def __init__(self, root_dir, frame_shape=(256, 256, 3), id_sampling=False,
                 is_train=True, random_seed=0, pairs_list=None,
                 augmentation_params=None, video_list=None, name=None,
                 device_augmentation=False):
        split_img = "train_fo" if is_train else "test_fo"
        split_audio = "train" if is_train else "test"
        self.image_dir = os.path.join(root_dir, "align_img", split_img)
        self.audio_dir = os.path.join(root_dir, "MFCC", split_audio)
        self.pose_dir = os.path.join(root_dir, "align_pose", split_img)
        self.pairs_list = pairs_list
        self.videos = _video_list(video_list, self.image_dir)
        self.is_train = is_train
        self.frame_hw = tuple(frame_shape[:2])
        self.device_aug = bool(device_augmentation) and is_train
        if self.device_aug:
            self.dev_samplers = _make_device_aug(augmentation_params)
            self.transform = None
        else:
            self.transform = (
                AllAugmentationTransform(**(augmentation_params or {}))
                if is_train else None)

    def __len__(self):
        return len(self.videos)

    @staticmethod
    def _window_start(n: int) -> int:
        return 0 if 16 < n < 24 else random.choice(range(3, n - 20))

    def __getitem__(self, idx):
        name = str(self.videos[idx]).split(".")[0]
        path = os.path.join(self.image_dir, name)
        mfcc = np.load(os.path.join(self.audio_dir, name + ".npy"))
        pose = np.load(os.path.join(self.pose_dir, name + ".npy"))
        r = self._window_start(len(mfcc))
        mfccs, poses = _window(mfcc, pose, r)
        decoded = _read_frames(
            [os.path.join(path, f"{r + ind}.png") for ind in range(0, 17)],
            hw=None, uint8=self.device_aug)
        example_image, video_array = decoded[0], decoded[1:]
        if self.transform is not None:
            video_array = np.asarray(self.transform(video_array))
        sample = {
            "example_image": example_image if self.device_aug
            else example_image.astype(np.float32),
            "driving": video_array if self.device_aug
            else video_array.astype(np.float32),
            "driving_audio": mfccs, "driving_pose": poses,
        }
        if self.device_aug:
            sample.update(_sample_device_aug(*self.dev_samplers))
        return sample


class MeadDataset:
    """MEAD-layout dataset for part2: the clean ``driving`` window, its
    augmented ``transformed_driving`` copy (or the decisions to build it on
    the device) and the integer ``emotion`` label."""

    def __init__(self, root_dir, frame_shape=(256, 256, 3), id_sampling=False,
                 is_train=True, random_seed=0, augmentation_params=None,
                 video_list=None, neutral_dict=None, name=None,
                 device_augmentation=False):
        self.image_dir = os.path.join(root_dir, "MEAD_fomm_crop")
        self.audio_dir = os.path.join(root_dir, "MEAD_MFCC")
        self.pose_dir = os.path.join(root_dir, "MEAD_fomm_pose_crop")
        self.videos = _video_list(video_list, self.image_dir)
        if neutral_dict is None:
            self.neutral = self._build_neutral_dict()
        elif isinstance(neutral_dict, str):
            self.neutral = np.load(neutral_dict, allow_pickle=True).item()
        else:
            self.neutral = dict(neutral_dict)
        self.is_train = is_train
        self.frame_hw = tuple(frame_shape[:2])
        self.device_aug = bool(device_augmentation)
        if self.device_aug:
            self.dev_samplers = _make_mead_device_aug(augmentation_params)
            self.transform = None
        else:
            self.transform = AllAugmentationTransform(
                **(augmentation_params or {}))

    def _build_neutral_dict(self) -> dict:
        """identity -> its clips whose name says neutral."""
        out: dict = {}
        for clip in self.videos:
            if "neutral" in clip.lower():
                out.setdefault(clip.split("/")[0], []).append(clip)
        return out

    @staticmethod
    def emotion_label(name: str) -> int:
        """The index in EMOTIONS of the first emotion the name contains
        (neutral when none)."""
        low = name.lower()
        for i, emo in enumerate(EMOTIONS):
            if emo in low:
                return i
        return EMOTIONS.index("neutral")

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, idx):
        from eamm_tpu_torch.data import packed
        name = str(self.videos[idx])
        path = os.path.join(self.image_dir, name)
        neu_list = self.neutral.get(name.split("/")[0], [name])
        neu_path = os.path.join(self.image_dir,
                                str(np.random.choice(neu_list)))
        mfcc = np.load(os.path.join(self.audio_dir, name + ".npy"))
        pose = one_euro_filter_np(
            np.load(os.path.join(self.pose_dir, name + ".npy")),
            mincutoff=0.01, beta=0.7, freq=100)
        neu_pack = packed.find_pack(neu_path)
        if neu_pack is not None:
            neu_name = f"{int(np.random.choice(packed.frame_ids(neu_pack)))}.png"
        else:
            neu_name = str(np.random.choice(sorted(
                f for f in os.listdir(neu_path) if f.endswith(".png"))))
        n = len(mfcc)
        r = 0 if 16 < n < 24 else random.choice(range(3, n - 20))
        mfccs, poses = _window(mfcc, pose, r)
        decoded = _read_frames(
            [os.path.join(neu_path, neu_name)]
            + [os.path.join(path, f"{r + ind}.png") for ind in range(1, 17)],
            hw=None, uint8=self.device_aug)
        example_image, video_array = decoded[0], decoded[1:]
        sample = {"driving_audio": mfccs, "driving_pose": poses,
                  "emotion": np.int32(self.emotion_label(name))}
        if self.device_aug:
            sample["example_image"] = example_image
            sample["driving"] = video_array
            T, h, w = video_array.shape[:3]
            sample.update(_sample_mead_device_aug(self.dev_samplers, T, h, w))
        else:
            transformed = np.asarray(self.transform(np.array(video_array)))
            sample["example_image"] = example_image.astype(np.float32)
            sample["driving"] = video_array.astype(np.float32)
            sample["transformed_driving"] = transformed.astype(np.float32)
        return sample


class PairedDataset:
    """Source / driving pairs of a dataset's samples, drawn from ``seed``
    among the first ``number_of_pairs`` items (``animate``'s evaluation)."""

    def __init__(self, initial_dataset, number_of_pairs, seed=0):
        self.initial_dataset = initial_dataset
        rng = np.random.RandomState(seed)
        max_idx = min(number_of_pairs, len(initial_dataset))
        xy = np.mgrid[:max_idx, :max_idx].reshape(2, -1).T
        number_of_pairs = min(xy.shape[0], number_of_pairs)
        self.pairs = xy.take(rng.choice(xy.shape[0], number_of_pairs,
                                        replace=False), axis=0)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx):
        first = self.initial_dataset[self.pairs[idx][0]]
        second = self.initial_dataset[self.pairs[idx][1]]
        return {**{f"driving_{k}": v for k, v in first.items()},
                **{f"source_{k}": v for k, v in second.items()}}


class DatasetRepeater:
    """Epoch lengthening (ref:frames_dataset.py:461-480)."""

    def __init__(self, dataset, num_repeats=100):
        self.dataset = dataset
        self.num_repeats = num_repeats

    def __len__(self):
        return self.num_repeats * len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]



class DataLoader:
    """Minimal threaded, prefetching batch loader.

    The reference trains with ``torch.utils.data.DataLoader(num_workers=0)``
    (ref:train.py:47) — i.e. synchronous loading on the training thread.
    Here a small thread pool decodes samples and a bounded queue prefetches
    whole batches so host IO overlaps device compute.
    """

    def __init__(self, dataset, batch_size, shuffle=True, num_workers=4,
                 prefetch=2, drop_last=True, seed=0, shard=None):
        """shard: optional ``(index, count)`` — this loader serves every
        count-th batch starting at index: with the same shuffle (same
        seed) on every process, the processes take disjoint slices."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.rng = random.Random(seed)
        if shard is not None:
            index, count = shard
            if not 0 <= index < count:
                raise ValueError(f"shard index {index} not in [0, {count})")
        self.shard = shard

    def _batch_indices(self):
        indices = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(indices)
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.shard is not None:
            index, count = self.shard
            batches = batches[index::count]
        return batches

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        if self.shard is not None:
            index, count = self.shard
            n = len(range(index, n, count))
        return n

    def _collate(self, samples):
        out = {}
        for key in samples[0]:
            out[key] = np.stack([s[key] for s in samples])
        return out

    def __iter__(self):
        batches = self._batch_indices()

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        cancel = threading.Event()

        def producer():
            # Lazy bounded submission: at most prefetch + num_workers batches
            # are materialized at any time even when the consumer stalls
            # (submitting everything up front lets completed futures —
            # ~107 MB per part1 batch — accumulate without bound).
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor
            it = iter(batches)
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    pending: deque = deque()

                    def submit_next():
                        b = next(it, None)
                        if b is not None:
                            pending.append(pool.submit(
                                lambda b=b: self._collate(
                                    [self.dataset[i] for i in b])))

                    for _ in range(self.num_workers):
                        submit_next()
                    while pending and not cancel.is_set():
                        item = pending.popleft().result()
                        while not cancel.is_set():
                            try:
                                q.put(item, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                        submit_next()
                sentinel = stop
            except BaseException as e:      # surface decode errors to the
                sentinel = ("__error__", e)  # consumer instead of hanging it
            while not cancel.is_set():
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] == "__error__":
                    raise item[1]
                yield item
        finally:
            cancel.set()
            # deterministic shutdown: in-flight decodes finish while their
            # inputs still exist (callers may delete the dataset dir right
            # after closing the iterator)
            t.join(timeout=10.0)
