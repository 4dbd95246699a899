"""``jaco_net: gan``: ATNet with the StyleGAN2 synthesis decoder, from the
model to the entry points, against the JAX package on the CPU.

- the gan ATNet's state_dict is the exact inverse of
  ``eamm_tpu.compat.convert_atnet`` (a reference file holds the deconv
  decoder too; the port's gan ATNet skips it);
- its maps within 1e-3 of the JAX ATNet(jaco_net='gan') on the converted
  weights, and the maps of chunks threaded through the LSTM's carry within
  5e-5 of the whole sequence's;
- the neutral render at TINY_CONFIG widths (EMOTION_TINY_CONFIG) against
  the JAX pipeline's on the same weights: per-frame mean |difference| max
  < 1e-2, mean < 3e-3;
- the reference's three files of a gan pipeline through the port's
  preflight (the JAX package's report) and ``from_torch_checkpoints``;
- ``eamm-torch-demo`` on a gan config, and ``eamm-torch-run --mode
  train_part1_fine_tune`` from the gan files, one step.
"""
import copy
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import EMOTION_TINY_CONFIG, save_checkpoints, with_gan_atnet
from eamm_tpu import compat as jax_compat
from eamm_tpu.compat import preflight as jax_preflight
from eamm_tpu.infer import EammPipeline as JaxPipeline
from eamm_tpu.infer import PipelineOptions as JaxOptions
from eamm_tpu.models import ATNet as JATNet
from eamm_tpu_torch import compat, config as cfg, convert
from eamm_tpu_torch.compat import preflight
from eamm_tpu_torch.infer import EammPipeline, PipelineOptions
from eamm_tpu_torch.infer.pipeline import reset_parameters
from eamm_tpu_torch.models import ATNet
from tests.test_infer_pipeline import _inputs

GAN_CONFIG = {**EMOTION_TINY_CONFIG, "train_params": {"jaco_net": "gan"}}
OPTS = dict(frame_chunk=8, time_bucket=8, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once, and a torch per worker spinning a thread per core
    slows every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def remove_files(tmp_path):
    """A training checkpoint holds ATNet at its full width with its Adam
    moments: each test's files go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _reference_file(atnet: ATNet) -> dict:
    """A gan ATNet's weights as the reference's audio file holds them:
    with the (unused) deconv decoder, as ``chip_smoke.save_checkpoints``
    writes it."""
    sd = {k: v.numpy() for k, v in atnet.state_dict().items()}
    decon = ATNet("cnn").decon
    reset_parameters(decon, torch.Generator().manual_seed(1))
    sd.update({f"decon.{k}": v.numpy()
               for k, v in decon.state_dict().items()})
    return sd


@pytest.fixture(scope="module")
def gan():
    """A seeded pipeline at EMOTION_TINY_CONFIG widths with a gan ATNet
    (``chip_smoke.with_gan_atnet``: its other models the cnn draw's) and
    the JAX variables of the same weights (through the JAX converters)."""
    pipe = with_gan_atnet(EammPipeline.from_random(
        EMOTION_TINY_CONFIG, 4, PipelineOptions(**OPTS)), 4)
    with torch.no_grad():                 # biases the initialization zeroes
        gen = torch.Generator().manual_seed(5)
        for name, p in pipe.models["audio_feature"].generator \
                .named_parameters():
            if name.endswith("bias") and "style" not in name:
                p.uniform_(-0.2, 0.2, generator=gen)
    sd = {name: {k: v.numpy() for k, v in m.state_dict().items()}
          for name, m in pipe.models.items()}
    variables = {
        "generator": jax_compat.convert_generator(sd["generator"]),
        "kp_detector": jax_compat.convert_kp_detector(sd["kp_detector"]),
        "kp_detector_a": jax_compat.convert_kp_detector_a(
            sd["kp_detector_a"]),
        "audio_feature": jax_compat.convert_atnet(
            _reference_file(pipe.models["audio_feature"])),
        "emo_detector": jax_compat.convert_emotion_k(sd["emo_detector"]),
    }
    return pipe, variables


def test_build_and_state_dict_inverse(gan):
    """build_atnet reads train_params.jaco_net ('gan' -> the synthesis
    decoder; another name raises).  The reference file of a gan ATNet
    (deconv decoder included) through convert_atnet and back is itself bit
    for bit; the JAX gan ATNet's own tree (no decoder) converts to exactly
    the port's state_dict, which loads strictly."""
    pipe, variables = gan
    atnet = pipe.models["audio_feature"]
    assert cfg.build_atnet(GAN_CONFIG).jaco_net == "gan"
    assert cfg.build_atnet({}).jaco_net == "cnn"
    with pytest.raises(ValueError, match="jaco_net"):
        cfg.build_atnet({"train_params": {"jaco_net": "vae"}})
    ref = _reference_file(atnet)
    back = convert.atnet_state_dict(jax_compat.convert_atnet(ref))
    assert sorted(back) == sorted(ref)
    for k, v in back.items():
        assert v.shape == ref[k].shape and np.array_equal(v.numpy(), ref[k]), k
    own = {part: {k: v for k, v in tree.items() if k != "decoder"}
           for part, tree in variables["audio_feature"].items()}
    sd = convert.state_dicts_from_jax({"audio_feature": own})["audio_feature"]
    ATNet("gan").load_state_dict(sd)
    assert sd.keys() == atnet.state_dict().keys()
    for k, v in atnet.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_window_features_match_jax_and_chunk(gan):
    """The gan ATNet's maps of 6 windows within 1e-3 of the JAX ATNet's on
    the converted weights (audio_weight 1.6); two chunks of 3 threaded
    through the LSTM's carry within 5e-5 of the whole (the cnn decoder's
    within 1e-5, tests/test_torch_delivery_stream.py: the CPU rounds the
    products of a batch of 3 and of 6 differently, and the synthesis
    network's MLP and modulations carry that further, 1.4e-5 here on maps
    of magnitude ~0.3)."""
    pipe, variables = gan
    atnet = pipe.models["audio_feature"]
    rng = np.random.RandomState(6)
    img = rng.rand(1, 256, 256, 3).astype(np.float32)
    audio = rng.randn(1, 6, 28, 12).astype(np.float32)
    pose = rng.randn(1, 6, 6).astype(np.float32)
    ref = jax.jit(lambda v, *a: JATNet(jaco_net="gan").apply(
        v, *a, audio_weight=1.6))(variables["audio_feature"],
                                  jnp.asarray(img), jnp.asarray(audio),
                                  jnp.asarray(pose))
    with torch.no_grad():
        feature = atnet.encode_image(torch.from_numpy(
            img.transpose(0, 3, 1, 2).copy()))
        a, p = torch.from_numpy(audio), torch.from_numpy(pose)
        whole = atnet.window_features(feature, a, p, 1.6)
        first, carry = atnet.window_features(feature, a[:, :3], p[:, :3],
                                             1.6, return_carry=True)
        second = atnet.window_features(feature, a[:, 3:], p[:, 3:], 1.6,
                                       carry=carry)
    np.testing.assert_allclose(whole.permute(0, 1, 3, 4, 2).numpy(),
                               np.asarray(ref), atol=1e-3, rtol=0)
    np.testing.assert_allclose(torch.cat([first, second], 1).numpy(),
                               whole.numpy(), atol=5e-5, rtol=0)


def test_gan_render_matches_jax(gan):
    """The neutral 1 s render of the gan pipeline against the JAX
    pipeline's on the same weights: per-frame mean |difference| max <
    1e-2, mean < 3e-3."""
    pipe, variables = gan
    jp = JaxPipeline(GAN_CONFIG, variables,
                     JaxOptions(frame_chunk=8, time_bucket=8))
    src, wav, pose, _ = _inputs()
    ref = jp.render(src, wav, pose, add_emo=False)
    ours = pipe.render(src, wav, pose, add_emo=False)
    assert ours.shape == ref.shape
    l1 = np.abs(ours - ref).mean(axis=(1, 2, 3))
    assert l1.max() < 1e-2, l1
    assert l1.mean() < 3e-3, l1.mean()


def _report(r):
    return (r.ok, r.fatal, r.skipped, str(r),
            [(m.name, m.family, m.missing, m.unused, m.n_matched, m.ok)
             for m in r.modules])


def test_gan_checkpoints_preflight_and_load(gan, tmp_path):
    """The gan pipeline's three reference files: the port's preflight
    gives the JAX package's report, ok; from_torch_checkpoints loads every
    model bit for bit, skipping and naming the audio file's deconv
    decoder; a cnn ATNet reading the same file skips the synthesis
    network instead."""
    pipe, _ = gan
    paths = save_checkpoints(pipe.models, str(tmp_path))
    for path in paths.values():
        ours = preflight.check_state_dict(path)
        assert _report(ours) == _report(jax_preflight.check_state_dict(path))
        assert ours.ok and not ours.fatal
    loaded = EammPipeline.from_torch_checkpoints(
        GAN_CONFIG, paths["fomm"], paths["audio"], paths["emo"],
        PipelineOptions(**OPTS))
    decon = sorted(k for k in torch.load(paths["audio"], weights_only=False)
                   ["audio_feature"] if k.startswith("decon."))
    assert loaded.ignored_keys["audio_feature"] == decon
    for name, model in pipe.models.items():
        got = loaded.models[name].state_dict()
        assert got.keys() == model.state_dict().keys(), name
        assert all(torch.equal(v, got[k])
                   for k, v in model.state_dict().items()), name
    cnn = ATNet("cnn")
    sd, skipped = compat.split_unused(
        compat.strip_prefix(torch.load(paths["audio"], weights_only=False)
                            ["audio_feature"]), cnn,
        compat.unused_prefixes("audio_feature", cnn))
    cnn.load_state_dict(sd)
    assert skipped and all(k.startswith("generator.") for k in skipped)


def test_demo_on_a_gan_config(gan, tmp_path, monkeypatch):
    """``eamm-torch-demo --cpu`` on a gan config and the gan pipeline's
    reference files: it builds the gan ATNet, skips the audio file's deconv
    decoder, and its neutral frames are bitwise ``render_uint8`` on the
    pipeline it built."""
    import yaml
    from scipy.io import wavfile

    from eamm_tpu_torch.cli import demo
    from eamm_tpu_torch.data import preprocess
    from tests.test_torch_entry import AUGMENTATION, _demo_argv
    pipe, _ = gan
    env = save_checkpoints(pipe.models, str(tmp_path))
    env["config"] = str(tmp_path / "config.yaml")
    with open(env["config"], "w") as f:
        yaml.safe_dump({**GAN_CONFIG, "dataset_params": {
            "augmentation_params": AUGMENTATION}}, f)
    rng = np.random.RandomState(0)
    for name, value in (("pose", rng.randn(4, 7).astype(np.float32)),
                        ("emotion", (rng.rand(3, 256, 256, 3) * 255)
                         .astype(np.uint8)),
                        ("source", rng.rand(256, 256, 3).astype(np.float32))):
        env[name] = str(tmp_path / f"{name}.npy")
        np.save(env[name], value)
    env["wav"] = str(tmp_path / "speech.wav")
    wavfile.write(env["wav"], 16000,
                  (0.3 * rng.randn(4800) * 32767 / 3).astype(np.int16))
    built = []
    build = demo.build_pipeline
    monkeypatch.setattr(demo, "build_pipeline",
                        lambda *a: built.append(build(*a)) or built[0])
    out = demo.main(_demo_argv(env, str(tmp_path / "out")))
    direct = built[0]
    assert direct.models["audio_feature"].jaco_net == "gan"
    assert all(k.startswith("decon.")
               for k in direct.ignored_keys["audio_feature"])
    np.testing.assert_array_equal(
        out["neutral"], direct.render_uint8(
            np.load(env["source"]), preprocess.load_audio(env["wav"]),
            np.load(env["pose"]), add_emo=False))


def test_fine_tune_cli_on_gan_files(gan, lrw_root, tmp_path):
    """``eamm-torch-run --cpu --mode train_part1_fine_tune`` on a gan
    config from the gan pipeline's reference files (the audio file's
    deconv decoder skipped), one step: the synthesis network trained,
    every weight finite.  (``train_part1`` on a gan config runs through
    the same ATNet on the card, ``chip_smoke.py`` phase 10.)"""
    from tests.test_torch_train_loop import _config, _write

    from eamm_tpu_torch.cli.run import main
    pipe, _ = gan
    config = copy.deepcopy(_config(lrw_root, jaco_net="gan"))
    paths = save_checkpoints(pipe.models, str(tmp_path))
    state = main(["--config", _write(config, tmp_path), "--mode",
                  "train_part1_fine_tune", "--cpu", "--max_steps", "1",
                  "--log_dir", str(tmp_path / "log"), "--fomm_checkpoint",
                  paths["fomm"], "--audio_checkpoint", paths["audio"]])
    assert state.step == 1
    assert state.models["audio_feature"].jaco_net == "gan"
    before = pipe.models["audio_feature"].generator.state_dict()
    after = state.models["audio_feature"].generator.state_dict()
    assert any(not torch.equal(v, after[k]) for k, v in before.items())
    assert all(torch.isfinite(v).all() for v in after.values())
