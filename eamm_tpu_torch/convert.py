"""JAX variable trees -> the port's ``state_dict``s.

``state_dicts_from_jax`` takes the JAX pipeline's ``variables`` (per model
``{'params': ..., 'batch_stats': ...}`` with numpy or array leaves) and
returns ``state_dict``s for the port's modules, which keep the reference
checkpoints' names.  It is the inverse of the JAX package's torch
converters (``eamm_tpu/compat/torch_convert.py``):

- Conv2d kernel HWIO -> OIHW;
- ConvTranspose2d: the JAX kernel is the spatially flipped HWIO kernel of
  the equivalent input-dilated conv -> unflip, back to [I, O, kh, kw];
- Conv1d kernel [k, I, O] -> [O, I, k];
- Linear kernel [I, O] -> [O, I]; the audio encoder's first Linear reads
  a [512, 12, 2] map that JAX flattens (h, w, c) and torch (c, h, w), so
  its columns are permuted back;
- BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
  (``num_batches_tracked`` 0);
- LSTM w_ih/w_hh [in, 4H] -> weight_ih/weight_hh [4H, in];
- the discriminator's spectral-norm kernel and ``u`` -> ``weight_orig``
  and ``weight_u`` (the reference's ``nn.utils.spectral_norm`` names);
  VGG19 ``conv<i>`` -> torchvision's ``features.<i>``.
"""
from __future__ import annotations

import numpy as np
import torch


class _StateDict:
    """Collects torch-named tensors from JAX leaves."""

    def __init__(self, variables: dict):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: dict[str, torch.Tensor] = {}

    @staticmethod
    def _at(tree: dict, path: str):
        for part in path.split("/"):
            tree = tree[part]
        return tree

    def _put(self, name: str, value) -> None:
        self.sd[name] = torch.tensor(np.ascontiguousarray(value))

    def conv(self, path: str, name: str) -> None:
        leaf = self._at(self.params, path)
        self._put(f"{name}.weight", np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in leaf:
            self._put(f"{name}.bias", leaf["bias"])

    def conv1d(self, path: str, name: str) -> None:
        leaf = self._at(self.params, path)
        self._put(f"{name}.weight", np.asarray(leaf["kernel"]).transpose(2, 1, 0))
        self._put(f"{name}.bias", leaf["bias"])

    def conv_transpose(self, path: str, name: str) -> None:
        leaf = self._at(self.params, path)
        kernel = np.asarray(leaf["kernel"])                 # [kh, kw, I, O]
        self._put(f"{name}.weight", np.flip(kernel.transpose(2, 3, 0, 1), (2, 3)))
        self._put(f"{name}.bias", leaf["bias"])

    def linear(self, path: str, name: str, flatten_from_chw=None) -> None:
        leaf = self._at(self.params, path)
        w = np.asarray(leaf["kernel"]).T                    # [O, I]
        if flatten_from_chw is not None:
            C, H, W = flatten_from_chw
            w = w.reshape(-1, H, W, C).transpose(0, 3, 1, 2).reshape(-1, C * H * W)
        self._put(f"{name}.weight", w)
        self._put(f"{name}.bias", leaf["bias"])

    def norm(self, path: str, name: str) -> None:
        params, stats = self._at(self.params, path), self._at(self.stats, path)
        self._put(f"{name}.weight", params["scale"])
        self._put(f"{name}.bias", params["bias"])
        self._put(f"{name}.running_mean", stats["mean"])
        self._put(f"{name}.running_var", stats["var"])
        self.sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    def block(self, path: str, name: str) -> None:
        """Same/Down/UpBlock: conv + norm."""
        self.conv(f"{path}/conv", f"{name}.conv")
        self.norm(f"{path}/norm", f"{name}.norm")

    def hourglass(self, path: str, name: str) -> None:
        enc = self._at(self.params, f"{path}/encoder")
        for i in range(len(enc)):
            self.block(f"{path}/encoder/down{i}",
                       f"{name}.encoder.down_blocks.{i}")
            self.block(f"{path}/decoder/up{i}", f"{name}.decoder.up_blocks.{i}")

    def count(self, path: str, prefix: str) -> int:
        tree = self._at(self.params, path) if path else self.params
        return sum(1 for k in tree if k.startswith(prefix))

    def mlp(self, path: str, name: str) -> None:
        """_MLP ``fc0, fc1, ...`` -> Sequential Linear at 0, 2, 4, ..."""
        for i in range(self.count(path, "fc")):
            self.linear(f"{path}/fc{i}", f"{name}.{2 * i}")


def _kp_heads(b: _StateDict) -> None:
    b.conv("head/kp", "kp")
    b.conv("head/jacobian", "jacobian")


def kp_detector_state_dict(variables: dict) -> dict:
    b = _StateDict(variables)
    b.hourglass("predictor", "predictor")
    _kp_heads(b)
    return b.sd


def kp_detector_a_state_dict(variables: dict) -> dict:
    b = _StateDict(variables)
    _kp_heads(b)
    return b.sd


def generator_state_dict(variables: dict) -> dict:
    b = _StateDict(variables)
    b.block("first", "first")
    for i in range(b.count("", "down")):
        b.block(f"down{i}", f"down_blocks.{i}")
        b.block(f"up{i}", f"up_blocks.{i}")
    for i in range(b.count("", "res")):
        for part in ("conv1", "conv2"):
            b.conv(f"res{i}/{part}", f"bottleneck.r{i}.{part}")
        for part in ("norm1", "norm2"):
            b.norm(f"res{i}/{part}", f"bottleneck.r{i}.{part}")
    b.conv("final", "final")
    dm = "dense_motion_network"
    b.hourglass(f"{dm}/hourglass", f"{dm}.hourglass")
    b.conv(f"{dm}/mask", f"{dm}.mask")
    if "occlusion" in b.params[dm]:
        b.conv(f"{dm}/occlusion", f"{dm}.occlusion")
    return b.sd


def atnet_state_dict(variables: dict) -> dict:
    b = _StateDict(variables)
    if "generator" in b.params:
        raise NotImplementedError("jaco_net='gan' ATNet is not ported")
    for i in range(8):
        b.block(f"image_encoder/down{i}", f"down_blocks.{i}")
    b.linear("pose_encoder/fc0", "pose_encoder.0")
    b.linear("pose_encoder/fc1", "pose_encoder.2")
    for j, t in enumerate([0, 1, 3, 4, 5]):        # MaxPools sit at 2 and 6
        b.conv(f"audio_encoder/conv{j}/conv", f"audio_eocder.{t}.0")
        b.norm(f"audio_encoder/conv{j}/norm", f"audio_eocder.{t}.1")
    b.linear("audio_encoder/fc0", "audio_eocder_fc.0",
             flatten_from_chw=(512, 12, 2))
    b.linear("audio_encoder/fc1", "audio_eocder_fc.2")
    lstm = b.params["lstm"]
    for l in range(3):
        for part in ("ih", "hh"):
            b._put(f"lstm.weight_{part}_l{l}", np.asarray(lstm[f"w_{part}_l{l}"]).T)
        for part in ("ih", "hh"):
            b._put(f"lstm.bias_{part}_l{l}", lstm[f"b_{part}_l{l}"])
    for j, t in enumerate([0, 3, 6, 9, 12]):       # BN at 1, 4, 7, 10
        b.conv_transpose(f"decoder/decon{j}", f"decon.{t}")
        if j < 4:
            b.norm(f"decoder/norm{j}", f"decon.{t + 1}")
    return b.sd


def _emotion_trunk(b: _StateDict) -> None:
    """Hourglass, ResNet trunk and classifier of both emotion models."""
    b.hourglass("predictor", "predictor")
    b.conv("trunk/conv1", "conv1")
    b.norm("trunk/bn1", "bn1")
    for li in range(1, 5):
        for bi in range(2):
            path, name = f"trunk/layer{li}_{bi}", f"layer{li}.{bi}"
            for part in ("conv1", "conv2"):
                b.conv(f"{path}/{part}", f"{name}.{part}")
            for part in ("bn1", "bn2"):
                b.norm(f"{path}/{part}", f"{name}.{part}")
            if "ds_conv" in b.params["trunk"][f"layer{li}_{bi}"]:
                b.conv(f"{path}/ds_conv", f"{name}.downsample.0")
                b.norm(f"{path}/ds_bn", f"{name}.downsample.1")
    b.mlp("fc_p", "fc_p")
    b.linear("classify", "classify.last_fc")


def emotion_k_state_dict(variables: dict) -> dict:
    b = _StateDict(variables)
    _emotion_trunk(b)
    for mlp in ("fc_n", "fc_all", "fc_single"):
        if mlp in b.params:
            b.mlp(mlp, mlp)
    for jax_name, name in (("final_c0", "final.0"), ("final_c1", "final.3"),
                           ("final_c2", "final.5"), ("final4_c0", "final_4.0"),
                           ("final4_c1", "final_4.3"),
                           ("final10_c0", "final_10.0"),
                           ("final10_c1", "final_10.3")):
        if jax_name in b.params:
            b.conv1d(f"{jax_name}/conv", name)
    return b.sd


def emotion_map_state_dict(variables: dict) -> dict:
    b = _StateDict(variables)
    _emotion_trunk(b)
    b.mlp("fc_all", "fc_all")
    for j in range(4):                            # BN at 1, 4, 7
        b.conv_transpose(f"decon{j}", f"final.{3 * j}")
        if j < 3:
            b.norm(f"norm{j}", f"final.{3 * j + 1}")
    for head, suffix in (("head_10", ""), ("head_4", "_4")):
        b.conv(f"{head}/kp", f"kp{suffix}")
        b.conv(f"{head}/jacobian", f"jacobian{suffix}")
    return b.sd


def discriminator_state_dict(variables: dict) -> dict:
    """MultiScaleDiscriminator: per scale ``disc_<s>`` -> ``discs.<s>``;
    a spectral-norm conv's kernel -> ``weight_orig`` and its ``u``
    (batch_stats) -> ``weight_u``; InstanceNorm ``in_scale`` / ``in_bias``
    -> ``norm.weight`` / ``norm.bias``."""
    b = _StateDict(variables)

    def sn_conv(path: str, name: str) -> None:
        stats = b.stats
        for part in path.split("/"):
            stats = stats.get(part, {}) if isinstance(stats, dict) else {}
        b.conv(path, name)
        if "u" in stats:
            b.sd[f"{name}.weight_orig"] = b.sd.pop(f"{name}.weight")
            b._put(f"{name}.weight_u", stats["u"])

    for disc in b.params:
        name = f"discs.{disc[len('disc_'):]}"
        for i in range(b.count(disc, "down")):
            sn_conv(f"{disc}/down{i}/conv", f"{name}.down_blocks.{i}.conv")
            block = b.params[disc][f"down{i}"]
            if "in_scale" in block:
                b._put(f"{name}.down_blocks.{i}.norm.weight", block["in_scale"])
                b._put(f"{name}.down_blocks.{i}.norm.bias", block["in_bias"])
        sn_conv(f"{disc}/conv", f"{name}.conv")
    return b.sd


def vgg_state_dict(variables: dict) -> dict:
    """Vgg19 ``conv<i>`` -> torchvision's ``features.<i>``."""
    b = _StateDict(variables)
    for name in b.params:
        b.conv(name, f"features.{name[len('conv'):]}")
    return b.sd


def state_dicts_from_jax(variables: dict, emo_type: str = "linear_3") -> dict:
    """{'generator', 'kp_detector', 'kp_detector_a', 'audio_feature',
    ['emo_detector'], ['discriminator'], ['vgg']} -> port ``state_dict``s;
    the emotion model is EmotionMap for a 'map*' ``emo_type`` and EmotionK
    otherwise.  The linear maps above also carry a gradient tree (given as
    ``params``) to the port's names."""
    emotion = (emotion_map_state_dict if emo_type.startswith("map")
               else emotion_k_state_dict)
    convert = {"generator": generator_state_dict,
               "kp_detector": kp_detector_state_dict,
               "kp_detector_a": kp_detector_a_state_dict,
               "audio_feature": atnet_state_dict,
               "emo_detector": emotion,
               "discriminator": discriminator_state_dict,
               "vgg": vgg_state_dict}
    return {name: convert[name](v) for name, v in variables.items()
            if name in convert}
