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
  VGG19 ``conv<i>`` -> torchvision's ``features.<i>``;
- StyleGAN2: an equalized dense ``weight`` [I, O] -> [O, I]; a modulated
  ``weight`` HWIO -> [1, O, I, kh, kw] (an equalized conv's -> OIHW); a
  StyledConv's ``bias`` -> ``activate.bias``, a ToRGB's -> [1, C, 1, 1];
  the synthesis network's style MLP ``style<i>`` -> ``style.<i + 1>``,
  ``conv_up<i>`` / ``conv_same<i>`` -> ``convs.<2i>`` / ``convs.<2i+1>``,
  ``to_rgb_up<i>`` -> ``to_rgbs.<i>`` (the reference's names); the image
  networks keep the JAX names;
- the auxiliary networks (``models/aux.py``) the reference's names of the
  JAX package's converters; TFNet's AdaIN layers ``style_mod`` /
  ``style_mod1`` -> the port's ``input_style`` / ``output_style``.
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
    """The heads; a head that estimates no Jacobian has no ``jacobian``."""
    b.conv("head/kp", "kp")
    if "jacobian" in b.params["head"]:
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
    _dense_motion(b, "dense_motion_network/", "dense_motion_network.")
    return b.sd


def _dense_motion(b: _StateDict, path: str, name: str) -> None:
    """Dense motion's leaves under ``path`` (``''`` or ending in '/'),
    named under ``name`` (``''`` or ending in '.')."""
    params = b._at(b.params, path.rstrip("/")) if path else b.params
    b.hourglass(f"{path}hourglass", f"{name}hourglass")
    b.conv(f"{path}mask", f"{name}mask")
    if "occlusion" in params:
        b.conv(f"{path}occlusion", f"{name}occlusion")


def dense_motion_state_dict(variables: dict) -> dict:
    """A JAX ``DenseMotionNetwork``'s variables -> the port's
    ``DenseMotionNetwork`` state_dict."""
    b = _StateDict(variables)
    _dense_motion(b, "", "")
    return b.sd


def _audio_encoder(b: _StateDict, path: str, name: str = "audio_eocder",
                   fc: str = "audio_eocder_fc") -> None:
    """The AudioEncoder conv stack and its two Linears."""
    for j, t in enumerate([0, 1, 3, 4, 5]):        # MaxPools sit at 2 and 6
        b.conv(f"{path}/conv{j}/conv", f"{name}.{t}.0")
        b.norm(f"{path}/conv{j}/norm", f"{name}.{t}.1")
    b.linear(f"{path}/fc0", f"{fc}.0", flatten_from_chw=(512, 12, 2))
    b.linear(f"{path}/fc1", f"{fc}.2")


def _lstm(b: _StateDict, path: str, name: str) -> None:
    lstm = b.params[path]
    for l in range(3):
        for part in ("ih", "hh"):
            b._put(f"{name}.weight_{part}_l{l}",
                   np.asarray(lstm[f"w_{part}_l{l}"]).T)
        for part in ("ih", "hh"):
            b._put(f"{name}.bias_{part}_l{l}", lstm[f"b_{part}_l{l}"])


def _decon(b: _StateDict, path: str, name: str, n: int) -> None:
    """A ``decon`` Sequential of ``n`` transposed convs with BN between
    (``<path>decon<j>`` / ``<path>norm<j>`` -> ``<name>.<3j>`` /
    ``<name>.<3j+1>``)."""
    for j in range(n):
        b.conv_transpose(f"{path}decon{j}", f"{name}.{3 * j}")
        if j < n - 1:
            b.norm(f"{path}norm{j}", f"{name}.{3 * j + 1}")


def _atnet_trunk(b: _StateDict) -> None:
    for i in range(8):
        b.block(f"image_encoder/down{i}", f"down_blocks.{i}")
    b.linear("pose_encoder/fc0", "pose_encoder.0")
    b.linear("pose_encoder/fc1", "pose_encoder.2")
    _audio_encoder(b, "audio_encoder")


def atnet_state_dict(variables: dict) -> dict:
    """ATNet of either ``jaco_net``: the deconv decoder's keys where the
    tree holds ``decoder`` (a JAX cnn ATNet, or any tree converted from a
    reference file, which holds both), the synthesis network's under
    ``generator.`` where it holds ``generator``."""
    b = _StateDict(variables)
    _atnet_trunk(b)
    _lstm(b, "lstm", "lstm")
    if "decoder" in b.params:
        _decon(b, "decoder/", "decon", 5)
    if "generator" in b.params:
        b.sd.update(synthesis_state_dict({"params": b.params["generator"]},
                                         "generator."))
    return b.sd


# ------------------------------------------------------------ StyleGAN2

def _tensor(value) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(value))


def _equal_linear(sd: dict, leaf: dict, name: str,
                  flatten_from_chw=None) -> None:
    w = np.asarray(leaf["weight"]).T                    # [O, I]
    if flatten_from_chw is not None:
        C, H, W = flatten_from_chw
        w = w.reshape(-1, H, W, C).transpose(0, 3, 1, 2).reshape(-1, C * H * W)
    sd[f"{name}.weight"] = _tensor(w)
    sd[f"{name}.bias"] = _tensor(leaf["bias"])


def _modulated(sd: dict, leaf: dict, name: str) -> None:
    sd[f"{name}.weight"] = _tensor(
        np.asarray(leaf["weight"]).transpose(3, 2, 0, 1)[None])
    if "modulation" in leaf:
        _equal_linear(sd, leaf["modulation"], f"{name}.modulation")


def _styled_conv(sd: dict, leaf: dict, name: str) -> None:
    _modulated(sd, leaf["conv"], f"{name}.conv")
    sd[f"{name}.activate.bias"] = _tensor(leaf["bias"])


def synthesis_state_dict(variables: dict, prefix: str = "") -> dict:
    """SynthesisGenerator: the inverse of the JAX package's
    ``convert_stylegan2``."""
    p, sd = variables["params"], {}
    for i in range(sum(1 for k in p if k.startswith("style"))):
        _equal_linear(sd, p[f"style{i}"], f"{prefix}style.{i + 1}")

    def to_rgb(leaf, name):
        _modulated(sd, leaf["conv"], f"{name}.conv")
        sd[f"{name}.bias"] = _tensor(np.asarray(leaf["bias"])
                                     .reshape(1, -1, 1, 1))

    _styled_conv(sd, p["conv1"], f"{prefix}conv1")
    to_rgb(p["to_rgb1"], f"{prefix}to_rgb1")
    for li in range(sum(1 for k in p if k.startswith("conv_up"))):
        _styled_conv(sd, p[f"conv_up{li}"], f"{prefix}convs.{2 * li}")
        _styled_conv(sd, p[f"conv_same{li}"], f"{prefix}convs.{2 * li + 1}")
        to_rgb(p[f"to_rgb_up{li}"], f"{prefix}to_rgbs.{li}")
    return sd


def _conv_layer(sd: dict, leaf: dict, name: str) -> None:
    """ConvLayer: ``conv`` (EqualConv, weight HWIO) and its ``bias``."""
    conv = leaf["conv"]
    sd[f"{name}.conv.weight"] = _tensor(
        np.asarray(conv["weight"]).transpose(3, 2, 0, 1))
    if "bias" in conv:
        sd[f"{name}.conv.bias"] = _tensor(conv["bias"])
    if "bias" in leaf:
        sd[f"{name}.bias"] = _tensor(leaf["bias"])


def _res_block(sd: dict, leaf: dict, name: str) -> None:
    for part in ("conv1", "conv2", "skip"):
        if part in leaf:
            _conv_layer(sd, leaf[part], f"{name}.{part}")


def _image_blocks(sd: dict, p: dict, prefix: str = "") -> None:
    """Every ConvLayer, DResBlock and style-free StyledConv of a StyleGAN2
    image network, by its JAX name."""
    for key, leaf in p.items():
        if key.startswith(("res", "down")):
            _res_block(sd, leaf, f"{prefix}{key}")
        elif key.startswith("up"):
            _styled_conv(sd, leaf, f"{prefix}{key}")
        elif key in ("from_rgb", "final_conv", "final_linear", "to_rgb"):
            _conv_layer(sd, leaf, f"{prefix}{key}")


def stylegan2_discriminator_state_dict(variables: dict,
                                       prefix: str = "") -> dict:
    """StyleGAN2Discriminator; the global head's first dense layer reads
    the 4x4 map flattened (c, h, w), JAX's (h, w, c)."""
    p, sd = variables["params"], {}
    _image_blocks(sd, p, prefix)
    if "final_dense0" in p:
        c = np.asarray(p["final_dense0"]["weight"]).shape[1]
        _equal_linear(sd, p["final_dense0"], f"{prefix}final_dense0",
                      flatten_from_chw=(c, 4, 4))
        _equal_linear(sd, p["final_dense1"], f"{prefix}final_dense1")
    return sd


def tile_discriminator_state_dict(variables: dict) -> dict:
    return stylegan2_discriminator_state_dict(
        {"params": variables["params"]["discriminator"]}, "discriminator.")


def image_network_state_dict(variables: dict) -> dict:
    """StyleGAN2Encoder or StyleGAN2Decoder."""
    sd = {}
    _image_blocks(sd, variables["params"])
    return sd


def stylegan2_image_generator_state_dict(variables: dict) -> dict:
    p, sd = variables["params"], {}
    _image_blocks(sd, p["encoder"], "encoder.")
    _image_blocks(sd, p["decoder"], "decoder.")
    return sd


# ------------------------------------------------- auxiliary networks

def ct_encoder_state_dict(variables: dict) -> dict:
    b = _StateDict(variables)
    _audio_encoder(b, "encoder")
    return b.sd


def emotion_net_state_dict(variables: dict) -> dict:
    b = _StateDict(variables)
    for j, t in enumerate([0, 2, 3, 5]):            # MaxPools at 1, 4, 6
        b.conv(f"conv{j}/conv", f"emotion_eocder.{t}.0")
        b.norm(f"conv{j}/norm", f"emotion_eocder.{t}.1")
    b.linear("fc0", "emotion_eocder_fc.0")
    b.linear("fc1", "emotion_eocder_fc.2")
    return b.sd


def af2f_state_dict(variables: dict) -> dict:
    """AF2F and AF2FS (the same transposed-conv stack)."""
    b = _StateDict(variables)
    _decon(b, "", "decon", 5)
    return b.sd


def a2i_state_dict(variables: dict) -> dict:
    b = _StateDict(variables)
    for j, t in enumerate([0, 1, 3, 4]):            # MaxPools at 2, 5
        b.conv(f"conv{j}/conv", f"audio_eocder.{t}.0")
        b.norm(f"conv{j}/norm", f"audio_eocder.{t}.1")
    _decon(b, "", "decon", 4)
    return b.sd


def na_net_state_dict(variables: dict) -> dict:
    b = _StateDict(variables)
    _decon(b, "", "decon", 3)
    return b.sd


def _sub(variables: dict, key: str) -> dict:
    return {part: tree[key] for part, tree in variables.items()
            if key in tree}


def audio_feature_composite_state_dict(variables: dict) -> dict:
    """AudioFeature (``models/aux.py``): con_encoder, emo_encoder,
    decoder."""
    sd = {}
    for key, fn in (("con_encoder", ct_encoder_state_dict),
                    ("emo_encoder", emotion_net_state_dict),
                    ("decoder", af2f_state_dict)):
        sd.update({f"{key}.{k}": v for k, v in fn(_sub(variables, key))
                   .items()})
    return sd


def em_detector_state_dict(variables: dict) -> dict:
    b = _StateDict(variables)
    _emotion_trunk(b, neutral_mlp=False)
    return b.sd


def tfnet_state_dict(variables: dict) -> dict:
    """TFNet of any mode: 'concat' ``lstm_two``; the AdaIN modes ``lstm``
    and ``style_mod`` -> ``input_style``, ``style_mod1`` ->
    ``output_style``."""
    b = _StateDict(variables)
    _atnet_trunk(b)
    for path in ("lstm_two", "lstm"):
        if path in b.params:
            _lstm(b, path, path)
    _decon(b, "decoder/", "decon", 5)
    for path, name in (("style_mod", "input_style"),
                       ("style_mod1", "output_style")):
        if path in b.params:
            b.linear(path, name)
    return b.sd


def _emotion_trunk(b: _StateDict, neutral_mlp: bool = True) -> None:
    """Hourglass, ResNet trunk and classifier of the emotion models, with
    the neutral keypoints' MLP (``fc_p``) unless ``neutral_mlp`` is
    False."""
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
    if neutral_mlp:
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


# the networks no entry point builds, by the name ``state_dicts_from_jax``
# takes their variables under
AUXILIARY = {"stylegan2_synthesis": synthesis_state_dict,
             "stylegan2_discriminator": stylegan2_discriminator_state_dict,
             "tile_stylegan2_discriminator": tile_discriminator_state_dict,
             "stylegan2_encoder": image_network_state_dict,
             "stylegan2_decoder": image_network_state_dict,
             "stylegan2_image_generator":
                 stylegan2_image_generator_state_dict,
             "ct_encoder": ct_encoder_state_dict,
             "emotion_net": emotion_net_state_dict,
             "af2f": af2f_state_dict, "af2f_s": af2f_state_dict,
             "a2i": a2i_state_dict, "na_net": na_net_state_dict,
             "em_detector": em_detector_state_dict,
             "audio_feature_composite": audio_feature_composite_state_dict,
             "tf_net": tfnet_state_dict}


def state_dicts_from_jax(variables: dict, emo_type: str = "linear_3") -> dict:
    """{'generator', 'kp_detector', 'kp_detector_a', 'audio_feature' (either
    ``jaco_net``), ['emo_detector'], ['discriminator'], ['vgg'], and any of
    ``AUXILIARY``} -> port ``state_dict``s; the emotion model is
    EmotionMap for a 'map*' ``emo_type`` and EmotionK otherwise.  The
    linear maps above also carry a gradient tree (given as ``params``) to
    the port's names."""
    emotion = (emotion_map_state_dict if emo_type.startswith("map")
               else emotion_k_state_dict)
    convert = {"generator": generator_state_dict,
               "kp_detector": kp_detector_state_dict,
               "kp_detector_a": kp_detector_a_state_dict,
               "audio_feature": atnet_state_dict,
               "emo_detector": emotion,
               "discriminator": discriminator_state_dict,
               "vgg": vgg_state_dict, **AUXILIARY}
    return {name: convert[name](v) for name, v in variables.items()
            if name in convert}
