"""Checkpoint pre-flight: diff a ``.pth.tar``'s key inventory against the
reference state-dict names each loader expects, BEFORE loading.

Counterpart of ``eamm_tpu/compat/preflight.py``, whose inventories it
keeps key for key, so that both packages give one file the same report.

The reference's three-checkpoint inference contract (ref:demo.py:82-95,
ref:logger.py:52-81, ref:train.py:283-299) is all by-name: a checkpoint
with renamed / missing / extra keys fails deep inside conversion with a
bare ``KeyError``.  ``check_state_dict`` reports every problem up front:

    report = check_state_dict("audio.pth.tar")
    if not report.ok:
        print(report)

Each module family's expected key set mirrors the reads of the JAX
package's converter for it (sizes inferred from the state dict the same
way); ``tests/test_torch_entry.py`` holds the reports to the JAX module's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping

from eamm_tpu_torch.compat import count_indexed as _count
from eamm_tpu_torch.compat import strip_prefix as _strip_prefix

# torch BatchNorm bookkeeping the converters never read (by design)
IGNORED_SUFFIXES = (".num_batches_tracked",)


# ------------------------------------------------------- leaf key inventories

def _conv2d(sd, pfx, keys, bias=True):
    keys.add(f"{pfx}.weight")
    if bias and f"{pfx}.bias" in sd:
        keys.add(f"{pfx}.bias")


_conv1d = _conv2d
_convT = _conv2d


def _linear(sd, pfx, keys):
    keys.add(f"{pfx}.weight")
    if f"{pfx}.bias" in sd:
        keys.add(f"{pfx}.bias")


def _bn(sd, pfx, keys):
    keys.update({f"{pfx}.weight", f"{pfx}.bias", f"{pfx}.running_mean",
                 f"{pfx}.running_var"})


def _lstm(sd, pfx, keys, num_layers=3):
    for l in range(num_layers):
        keys.update({f"{pfx}.weight_ih_l{l}", f"{pfx}.weight_hh_l{l}",
                     f"{pfx}.bias_ih_l{l}", f"{pfx}.bias_hh_l{l}"})


def _block(sd, pfx, keys):
    _conv2d(sd, f"{pfx}.conv", keys)
    _bn(sd, f"{pfx}.norm", keys)


def _conv_block(sd, pfx, keys):
    _conv2d(sd, f"{pfx}.0", keys)
    _bn(sd, f"{pfx}.1", keys)


def _hourglass(sd, pfx, keys, num_blocks):
    for i in range(num_blocks):
        _block(sd, f"{pfx}.encoder.down_blocks.{i}", keys)
        _block(sd, f"{pfx}.decoder.up_blocks.{i}", keys)


def _resblock(sd, pfx, keys):
    _conv2d(sd, f"{pfx}.conv1", keys)
    _conv2d(sd, f"{pfx}.conv2", keys)
    _bn(sd, f"{pfx}.norm1", keys)
    _bn(sd, f"{pfx}.norm2", keys)


def _emotion_trunk(sd, keys, num_blocks):
    _hourglass(sd, "predictor", keys, num_blocks)
    _conv2d(sd, "conv1", keys)
    _bn(sd, "bn1", keys)
    for li in range(1, 5):
        for bi in range(2):
            pfx = f"layer{li}.{bi}"
            _conv2d(sd, f"{pfx}.conv1", keys)
            _conv2d(sd, f"{pfx}.conv2", keys)
            _bn(sd, f"{pfx}.bn1", keys)
            _bn(sd, f"{pfx}.bn2", keys)
            if f"{pfx}.downsample.0.weight" in sd:
                _conv2d(sd, f"{pfx}.downsample.0", keys)
                _bn(sd, f"{pfx}.downsample.1", keys)


def _decon_stack(sd, keys, n_deconv, pfx="decon"):
    for i in range(n_deconv):
        _convT(sd, f"{pfx}.{3 * i}", keys)
        if i < n_deconv - 1:
            _bn(sd, f"{pfx}.{3 * i + 1}", keys)


def _atnet_trunk(sd, keys):
    for i in range(8):
        _block(sd, f"down_blocks.{i}", keys)
    _linear(sd, "pose_encoder.0", keys)
    _linear(sd, "pose_encoder.2", keys)
    for t in (0, 1, 3, 4, 5):
        _conv_block(sd, f"audio_eocder.{t}", keys)
    _linear(sd, "audio_eocder_fc.0", keys)
    _linear(sd, "audio_eocder_fc.2", keys)
    for t in (0, 3, 6, 9, 12):
        _convT(sd, f"decon.{t}", keys)
    for t in (1, 4, 7, 10):
        _bn(sd, f"decon.{t}", keys)


# ---------------------------------------------------------- family key sets

def _keys_kp_detector(sd):
    keys: set[str] = set()
    nb = _count(sd, "predictor.encoder.down_blocks.{}.conv.weight")
    _hourglass(sd, "predictor", keys, nb)
    _conv2d(sd, "kp", keys)
    if "jacobian.weight" in sd:
        _conv2d(sd, "jacobian", keys)
    return keys


def _keys_kp_detector_a(sd):
    keys: set[str] = set()
    _conv2d(sd, "kp", keys)
    if "jacobian.weight" in sd:
        _conv2d(sd, "jacobian", keys)
    return keys


def _keys_generator(sd):
    keys: set[str] = set()
    ndb = _count(sd, "down_blocks.{}.conv.weight")
    nbt = _count(sd, "bottleneck.r{}.conv1.weight")
    dnb = _count(
        sd, "dense_motion_network.hourglass.encoder.down_blocks.{}.conv.weight")
    _block(sd, "first", keys)
    for i in range(ndb):
        _block(sd, f"down_blocks.{i}", keys)
        _block(sd, f"up_blocks.{i}", keys)
    for i in range(nbt):
        _resblock(sd, f"bottleneck.r{i}", keys)
    _conv2d(sd, "final", keys)
    dm = "dense_motion_network"
    _hourglass(sd, f"{dm}.hourglass", keys, dnb)
    _conv2d(sd, f"{dm}.mask", keys)
    if f"{dm}.occlusion.weight" in sd:
        _conv2d(sd, f"{dm}.occlusion", keys)
    return keys


def _keys_stylegan2(sd, pfx="", size=64, n_mlp=8):
    import math
    if pfx and not pfx.endswith("."):
        pfx += "."
    keys: set[str] = set()

    def eq_linear(p):
        keys.update({f"{p}.weight", f"{p}.bias"})

    def mod_conv(p):
        keys.add(f"{p}.weight")
        eq_linear(f"{p}.modulation")

    def styled_conv(p):
        mod_conv(f"{p}.conv")
        keys.add(f"{p}.activate.bias")

    def to_rgb(p):
        mod_conv(f"{p}.conv")
        keys.add(f"{p}.bias")

    for i in range(n_mlp):
        eq_linear(f"{pfx}style.{i + 1}")
    styled_conv(f"{pfx}conv1")
    to_rgb(f"{pfx}to_rgb1")
    for li in range(int(math.log2(size)) - 2):
        styled_conv(f"{pfx}convs.{2 * li}")
        styled_conv(f"{pfx}convs.{2 * li + 1}")
        to_rgb(f"{pfx}to_rgbs.{li}")
    return keys


def _keys_atnet(sd):
    keys: set[str] = set()
    _atnet_trunk(sd, keys)
    _lstm(sd, "lstm", keys, 3)
    if "generator.conv1.conv.weight" in sd:    # jaco_net='gan' decoder
        keys |= _keys_stylegan2(sd, "generator")
    return keys


def _keys_tfnet(sd):
    keys: set[str] = set()
    _atnet_trunk(sd, keys)
    _lstm(sd, "lstm_two", keys, 3)
    return keys


def _keys_emotion_k(sd):
    keys: set[str] = set()
    nb = _count(sd, "predictor.encoder.down_blocks.{}.conv.weight")
    _emotion_trunk(sd, keys, nb)
    for p in ("fc_p.0", "fc_p.2", "fc_n.0", "fc_n.2",
              "fc_all.0", "fc_all.2", "fc_all.4", "classify.last_fc"):
        _linear(sd, p, keys)
    if "fc_single.0.weight" in sd:
        _linear(sd, "fc_single.0", keys)
        _linear(sd, "fc_single.2", keys)
    for p in ("final.0", "final.3", "final.5",
              "final_10.0", "final_10.3"):
        _conv1d(sd, p, keys)
    if "final_4.0.weight" in sd:
        _conv1d(sd, "final_4.0", keys)
        _conv1d(sd, "final_4.3", keys)
    return keys


def _keys_emotion_map(sd):
    keys: set[str] = set()
    nb = _count(sd, "predictor.encoder.down_blocks.{}.conv.weight")
    _emotion_trunk(sd, keys, nb)
    for p in ("fc_p.0", "fc_p.2", "fc_all.0", "classify.last_fc"):
        _linear(sd, p, keys)
    for t in (0, 3, 6, 9):
        _convT(sd, f"final.{t}", keys)
    for t in (1, 4, 7):
        _bn(sd, f"final.{t}", keys)
    for p in ("kp", "jacobian", "kp_4", "jacobian_4"):
        _conv2d(sd, p, keys)
    return keys


def _keys_em_detector(sd):
    keys: set[str] = set()
    nb = _count(sd, "predictor.encoder.down_blocks.{}.conv.weight")
    _emotion_trunk(sd, keys, nb)
    _linear(sd, "classify.last_fc", keys)
    return keys


def _keys_ct_encoder(sd):
    keys: set[str] = set()
    for t in (0, 1, 3, 4, 5):
        _conv_block(sd, f"audio_eocder.{t}", keys)
    _linear(sd, "audio_eocder_fc.0", keys)
    _linear(sd, "audio_eocder_fc.2", keys)
    return keys


def _keys_emotion_net(sd):
    keys: set[str] = set()
    for t in (0, 2, 3, 5):
        _conv_block(sd, f"emotion_eocder.{t}", keys)
    _linear(sd, "emotion_eocder_fc.0", keys)
    _linear(sd, "emotion_eocder_fc.2", keys)
    return keys


def _keys_af2f(sd):
    keys: set[str] = set()
    _decon_stack(sd, keys, 5)
    return keys


def _keys_a2i(sd):
    keys: set[str] = set()
    for t in (0, 1, 3, 4):
        _conv_block(sd, f"audio_eocder.{t}", keys)
    _decon_stack(sd, keys, 4)
    return keys


def _keys_na_net(sd):
    keys: set[str] = set()
    _decon_stack(sd, keys, 3)
    return keys


def _keys_audio_feature_composite(sd):
    keys: set[str] = set()
    for pfx, fn in (("con_encoder", _keys_ct_encoder),
                    ("emo_encoder", _keys_emotion_net),
                    ("decoder", _keys_af2f)):
        sub = {k[len(pfx) + 1:]: v for k, v in sd.items()
               if k.startswith(pfx + ".")}
        keys |= {f"{pfx}.{k}" for k in fn(sub)}
    return keys


def _keys_discriminator(sd):
    keys: set[str] = set()
    tags = sorted({k.split(".")[1] for k in sd if k.startswith("discs.")})

    def sn_conv(pfx):
        if f"{pfx}.weight_orig" in sd:
            keys.update({f"{pfx}.weight_orig", f"{pfx}.bias",
                         f"{pfx}.weight_u"})
        else:
            _conv2d(sd, pfx, keys)

    for tag in tags:
        t = f"discs.{tag}"
        i = 0
        while (f"{t}.down_blocks.{i}.conv.weight" in sd
               or f"{t}.down_blocks.{i}.conv.weight_orig" in sd):
            sn_conv(f"{t}.down_blocks.{i}.conv")
            if f"{t}.down_blocks.{i}.norm.weight" in sd:
                keys.update({f"{t}.down_blocks.{i}.norm.weight",
                             f"{t}.down_blocks.{i}.norm.bias"})
            i += 1
        sn_conv(f"{t}.conv")
    return keys


# Keys real reference checkpoints contain that the converters deliberately
# skip: dead heads commented out of the reference forwards, the fixed
# AntiAliasInterpolation2d Gaussian buffer (recomputed in-framework,
# ref:modules/util.py:1038), and KPDetector_a's never-called hourglass
# (ref:modules/keypoint_detector.py:120).  Matched as exact key or prefix.
FAMILY_TOLERATED: dict[str, tuple[str, ...]] = {
    "kp_detector": ("down.weight",),
    "kp_detector_a": ("predictor.", "down.weight"),
    "generator": ("dense_motion_network.down.weight",),
    "emotion_k": ("down.weight", "fc.weight", "fc.bias"),
    "emotion_map": ("down.weight", "fc.weight", "fc.bias"),
    "em_detector": ("down.weight", "fc.weight", "fc.bias"),
    "emotion_net": ("last_fc.", "re_id.", "re_id_fc."),
    "tfnet": ("lstm.", "generator.", "style_mod.", "style_mod1.",
              "instance_norm."),
    # spectral_norm's right singular vector: recomputed by the in-framework
    # power iteration, only weight_orig/weight_u convert
    "discriminator": ("*.weight_v",),
}


def _tolerated(family: str, key: str) -> bool:
    for pat in FAMILY_TOLERATED.get(family, ()):
        if (key == pat
                or (pat.endswith(".") and key.startswith(pat))
                or (pat.startswith("*") and key.endswith(pat[1:]))):
            return True
    return False


FAMILY_KEYS: dict[str, Callable[[Mapping], set]] = {
    "kp_detector": _keys_kp_detector,
    "kp_detector_a": _keys_kp_detector_a,
    "generator": _keys_generator,
    "atnet": _keys_atnet,
    "tfnet": _keys_tfnet,
    "emotion_k": _keys_emotion_k,
    "emotion_map": _keys_emotion_map,
    "em_detector": _keys_em_detector,
    "ct_encoder": _keys_ct_encoder,
    "emotion_net": _keys_emotion_net,
    "af2f": _keys_af2f,
    "a2i": _keys_a2i,
    "na_net": _keys_na_net,
    "audio_feature_composite": _keys_audio_feature_composite,
    "discriminator": _keys_discriminator,
    "stylegan2": _keys_stylegan2,
}


def infer_family(module_name: str, sd: Mapping) -> str | None:
    """Module-entry name (ref:logger.py:44-50 save keys) + key shape ->
    converter family; None for non-model entries (optimizers, scalars)."""
    if not hasattr(sd, "keys"):
        return None
    keys = set(sd.keys())
    if {"state", "param_groups"} <= keys:            # torch optimizer
        return None
    name = module_name.lower()
    if "discriminator" in name:
        return "discriminator"
    if name == "generator" or "dense_motion_network.mask.weight" in keys:
        return "generator"
    if name == "kp_detector_a":
        return "kp_detector_a"
    if name == "kp_detector":
        return "kp_detector"
    if name in ("audio_feature", "tf_net", "at_net"):
        if any(k.startswith("lstm_two.") for k in keys):
            return "tfnet"
        if any(k.startswith("lstm.") for k in keys):
            return "atnet"
        if any(k.startswith("con_encoder.") for k in keys):
            return "audio_feature_composite"
    if name == "emo_detector" or name.startswith("emotion"):
        if "kp_4.weight" in keys:
            return "emotion_map"
        if any(k.startswith("fc_n.") for k in keys):
            return "emotion_k"
        if any(k.startswith("classify.") for k in keys):
            return "em_detector"
    # last-resort structural guesses for nonstandard module names
    if any(k.startswith("predictor.") for k in keys):
        if "kp_4.weight" in keys:
            return "emotion_map"
        if any(k.startswith("fc_n.") for k in keys):
            return "emotion_k"
        if any(k.startswith("classify.") for k in keys):
            return "em_detector"
        return "kp_detector"
    if {"kp.weight"} <= keys and len(keys) <= 4:
        return "kp_detector_a"
    return None


@dataclass
class ModuleReport:
    name: str
    family: str | None
    missing: list[str] = field(default_factory=list)
    unused: list[str] = field(default_factory=list)
    n_matched: int = 0

    @property
    def ok(self) -> bool:
        return self.family is not None and not self.missing and not self.unused

    @property
    def fatal(self) -> bool:
        """Missing keys make conversion raise; unused keys are a warning."""
        return bool(self.missing)


@dataclass
class CheckReport:
    path: str | None
    modules: list[ModuleReport] = field(default_factory=list)
    skipped: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(m.ok for m in self.modules)

    @property
    def fatal(self) -> bool:
        return any(m.fatal for m in self.modules)

    def __str__(self) -> str:
        lines = [f"checkpoint pre-flight: {self.path or '<dict>'}"]
        for m in self.modules:
            if m.family is None:
                lines.append(f"  {m.name}: UNRECOGNIZED module family "
                             f"(no converter matched its keys)")
                continue
            status = "OK" if m.ok else ("MISSING KEYS" if m.missing
                                        else "extra keys")
            lines.append(f"  {m.name} [{m.family}]: {status} "
                         f"({m.n_matched} matched)")
            for k in m.missing[:20]:
                lines.append(f"    missing: {k}")
            if len(m.missing) > 20:
                lines.append(f"    ... and {len(m.missing) - 20} more missing")
            for k in m.unused[:20]:
                lines.append(f"    unused:  {k}")
            if len(m.unused) > 20:
                lines.append(f"    ... and {len(m.unused) - 20} more unused")
        if self.skipped:
            lines.append(f"  (non-model entries: {', '.join(self.skipped)})")
        return "\n".join(lines)


def check_state_dict(ckpt, family: str | None = None,
                     path: str | None = None) -> CheckReport:
    """Diff checkpoint key inventories against the converters' expectations.

    ``ckpt``: a ``.pth.tar`` path, the ``load_torch_checkpoint`` output
    ({module_name: state_dict}), or a single flat state dict when
    ``family`` names the converter to check against.
    """
    if isinstance(ckpt, str):
        from eamm_tpu_torch.compat import load_torch_checkpoint
        path = ckpt
        ckpt = load_torch_checkpoint(ckpt)
    if family is not None:
        ckpt = {family: ckpt}

    report = CheckReport(path=path)
    for name, sd in ckpt.items():
        fam = family if family is not None else infer_family(name, sd)
        if fam is None:
            if hasattr(sd, "keys") and not {"state",
                                            "param_groups"} <= set(sd.keys()):
                report.modules.append(ModuleReport(name=name, family=None))
            else:
                report.skipped.append(name)
            continue
        stripped = _strip_prefix(sd)
        expected = FAMILY_KEYS[fam](stripped)
        present = {k for k in stripped
                   if not k.endswith(IGNORED_SUFFIXES)}
        report.modules.append(ModuleReport(
            name=name, family=fam,
            missing=sorted(expected - present),
            unused=sorted(k for k in present - expected
                          if not _tolerated(fam, k)),
            n_matched=len(expected & present)))
    return report
