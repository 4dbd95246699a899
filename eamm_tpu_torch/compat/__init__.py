"""The reference's ``.pth.tar`` checkpoints (PyTorch).

Counterpart of ``eamm_tpu/compat/torch_convert.py``'s loader: the port's
modules keep the reference ``state_dict`` names, so a checkpoint needs no
conversion, only its DataParallel ``module.`` prefixes dropped.  The
reference's files also carry optimizer states and epoch numbers, so they
are read with ``weights_only=False``, on the CPU.  ``preflight`` diffs a
file's key inventory against what the loaders read, before loading.
"""
from __future__ import annotations

from typing import Mapping

import torch


def load_torch_checkpoint(path: str) -> dict:
    """A ``.pth.tar`` -> {entry name: state_dict of CPU tensors, or the
    entry as saved (an optimizer's state, an epoch number)}."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return {name: (dict(entry.items()) if hasattr(entry, "items") else entry)
            for name, entry in ckpt.items()}


def strip_prefix(sd: Mapping) -> dict:
    """Drop DataParallel 'module.' prefixes."""
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def count_indexed(sd: Mapping, fmt: str) -> int:
    """Number of consecutive indices i for which fmt.format(i) is a key."""
    i = 0
    while fmt.format(i) in sd:
        i += 1
    return i


# keys of the reference's Emotion_k that no head of the render runs and
# the port's EmotionK does not hold: the unused ``final_4`` Conv1d stack
EMOTION_K_UNUSED = ("final_4.",)

# keys of the reference's AT_net that the port's ATNet of each decoder
# does not hold: the reference builds both the deconv decoder and the
# StyleGAN2 synthesis network whatever ``jaco_net`` says, so its files may
# hold both, and the JAX package reads the one its model runs
ATNET_UNUSED = {"cnn": ("generator.",), "gan": ("decon.",)}


def unused_prefixes(name: str, module: torch.nn.Module) -> tuple[str, ...]:
    """The key prefixes a reference file holds for model ``name`` that
    ``module`` does not (``split_unused``)."""
    if name == "emo_detector":
        return EMOTION_K_UNUSED
    if name == "audio_feature":
        return ATNET_UNUSED[module.jaco_net]
    return ()


def model_state_dicts(fomm: Mapping, audio: Mapping, emo: Mapping) -> dict:
    """The three loaded checkpoints -> the render's five state_dicts by
    model name, prefixes stripped."""
    return {"generator": strip_prefix(fomm["generator"]),
            "kp_detector": strip_prefix(fomm["kp_detector"]),
            "kp_detector_a": strip_prefix(audio["kp_detector_a"]),
            "audio_feature": strip_prefix(audio["audio_feature"]),
            "emo_detector": strip_prefix(emo["emo_detector"])}


def split_unused(sd: Mapping, module: torch.nn.Module,
                 unused: tuple[str, ...]) -> tuple[dict, list[str]]:
    """(the keys of ``sd`` that ``module`` holds, the sorted keys under an
    ``unused`` prefix that it does not hold).  Any other key is left in,
    so that a strict load still refuses it."""
    own = set(module.state_dict())
    dropped = sorted(k for k in sd if k not in own and k.startswith(unused))
    return {k: v for k, v in sd.items() if k not in dropped}, dropped
