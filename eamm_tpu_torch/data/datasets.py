"""Part1 training's dataset reader, repeater and loader (NHWC numpy).

The port's copy of the part1 pieces of ``eamm_tpu/data/datasets.py``:

- **LRW / AudioDataset**: ``Image/{train_fo,test_fo}/<word>/<clip>/<N>.png``,
  ``MFCC/{train,test}/<word>/<clip>/<N>.npy`` ([28, 13] windows),
  ``pose/{train_fo,test_fo}/<word>/<clip>.npy`` ([M, 7]); a sample holds
  example_image [256,256,3], driving [16,256,256,3], driving_audio
  [16,28,12] and driving_pose [16,6], float32, or with
  ``device_augmentation`` uint8 frames and the per-clip flip and jitter
  decisions (``ops/augment.py`` applies them on the device);
- ``DatasetRepeater`` (epoch lengthening) and ``DataLoader`` (a thread
  pool decoding samples, a bounded queue of prefetched batches).

Frames come from a ``frames.eammpack`` next to the PNGs when there is one
(``data/packed.py``), else from the PNGs through imageio (the JAX
package's libpng batch decoder is not ported).  ``VoxDataset``,
``MeadDataset`` and ``PairedDataset`` wait for part2 (ROADMAP Queue 1).
"""
from __future__ import annotations

import os
import queue
import random
import threading

import numpy as np

from eamm_tpu_torch.data.augmentation import AllAugmentationTransform


def decode_pngs(paths: list[str], h: int, w: int) -> np.ndarray:
    """PNGs -> [N, h, w, 3] float32 in [0, 1]; every file must be h x w."""
    import imageio.v2 as imageio
    out = np.empty((len(paths), h, w, 3), np.float32)
    for i, p in enumerate(paths):
        img = np.asarray(imageio.imread(p))
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        if img.shape[:2] != (h, w):
            raise IOError(f"{p}: {img.shape[:2]} is not the window's "
                          f"{(h, w)}")
        out[i] = img[..., :3].astype(np.float32) * np.float32(1.0 / 255.0)
    return out


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
    everything else is decoded by imageio (``decode_pngs``).  hw=None
    loads at the files' own resolution (reference semantics: clips are
    pre-cropped, never resized at load time).  uint8=True serves raw bytes
    (the device-augmentation upload format — a pure copy on the packed
    path; exact either way since PNGs store uint8)."""
    from eamm_tpu_torch.data import packed

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
        return from_f32(decode_pngs(paths, hw[0], hw[1]))

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
        out[png_rows] = from_f32(decode_pngs(
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
        if video_list is not None:
            self.videos = list(np.load(video_list)) \
                if isinstance(video_list, str) else list(video_list)
        else:
            self.videos = _discover_clips(self.image_dir)
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
