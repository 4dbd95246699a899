"""What decides ``correct``: the frozen reference equals the port on the
CPU at tiny widths on the same state dicts; the control and the faults a
cell can have come out not correct."""
from __future__ import annotations

import numpy as np
import pytest

from perfbench.tests.conftest import F32, needs_card


def test_reference_equals_the_port_render(tiny_run):
    """Float32 everywhere: the port's served yuv420 frames are the
    reference's, to the count."""
    result, run = tiny_run("cnn-serve-closed8", config=F32)
    assert max(run.facts["worst_frame_block_abs"]) <= 0.01
    assert run.checks["length_mismatches"][0] == 0
    assert result["correct"] is True


@pytest.mark.parametrize("cell", ["gan-part1-train", "cnn-finetune-train"])
def test_reference_equals_the_port_step(tiny_run, cell):
    """The port's first step's loss and first gradients are the
    reference's to float32 rounding (the median leaf's change too)."""
    _, run = tiny_run(cell)
    gaps = run.facts["gaps"]
    assert gaps["loss_gap_first"] < 1e-5
    assert gaps["grad_gap"] < 5e-2
    assert gaps["change_gap_median"] < 1e-3


def test_control_render_is_not_correct(tiny_run, monkeypatch):
    """The reference with the generator in fp8 in the program's place."""
    from perfbench.drivers import serve_closed as D
    original = D.compare
    monkeypatch.setattr(D, "compare", lambda run, sds, sample, control=False:
                        original(run, sds, sample, control=True))
    result, run = tiny_run("cnn-serve-closed8", config=F32)
    assert result["correct"] is False


@pytest.mark.card
def test_control_step_is_not_correct():
    """TF32 exists only on the card: the reference in TF32 put in the
    program's place must fail the training cells' limits (run on the card
    at the cells' sizes by ``perfbench/calibrate.py``)."""
    needs_card()
    import json
    import subprocess
    import sys
    from perfbench.tests.conftest import ROOT
    for cell in ("gan-part1-train", "cnn-finetune-train"):
        out = subprocess.run(
            [sys.executable, str(ROOT / "perfbench/calibrate.py"),
             "--workload", cell, "--seeds", "1", "--seconds", "1"],
            capture_output=True, text=True, check=True).stdout
        line = json.loads(out.strip().splitlines()[-1])
        limits = json.loads((ROOT / f"perfbench/workloads/{cell}.json")
                            .read_text())["check"]["limits"]
        assert any(line["control"][k] > v for k, v in limits.items())


def _alter_answer(monkeypatch):
    from eamm_tpu_torch.serve import RenderServer
    finish = RenderServer._finish

    def altered(self, group, results):
        for y, _, _ in results:
            y[0] = np.clip(y[0].astype(np.int16) + 40, 0, 255)
        return finish(self, group, results)
    monkeypatch.setattr(RenderServer, "_finish", altered)


def _half_the_batch(monkeypatch):
    """The dispatch renders the first half of its clips and hands those
    frames to the second half too."""
    from eamm_tpu_torch.infer.pipeline import EammPipeline
    render = EammPipeline.render_batch_yuv420

    def half(self, sources, wavs, poses):
        h = max(1, len(sources) // 2)
        planes = render(self, sources[:h], wavs[:h], poses[:h])
        return tuple(np.concatenate([p] * (len(sources) // h + 1))[
            :len(sources)] for p in planes)
    monkeypatch.setattr(EammPipeline, "render_batch_yuv420", half)


def _filter_unadapted(monkeypatch):
    """The audio keypoints' one-euro filter without its speed term: the
    keypoints lag the speech."""
    from eamm_tpu_torch.infer import pipeline
    euro = pipeline.one_euro_filter
    monkeypatch.setattr(pipeline, "one_euro_filter",
                        lambda *a, **k: euro(*a, **dict(k, beta=0.0)))


@pytest.mark.parametrize("fault", [_alter_answer, _half_the_batch,
                                   _filter_unadapted],
                         ids=["answer_altered", "half_the_batch",
                              "filter_unadapted"])
def test_serving_faults_are_not_correct(tiny_run, monkeypatch, fault):
    fault(monkeypatch)
    result, _ = tiny_run("cnn-serve-closed8",
                         cell_over={"traffic": {"identities": 4}})
    assert result["correct"] is False


def _state_unchanged(monkeypatch):
    from eamm_tpu_torch.train.optim import ScheduledAdam
    monkeypatch.setattr(ScheduledAdam, "step", lambda self: None)


def _half_batch_mean(monkeypatch):
    from eamm_tpu_torch.train import steps as S
    decode = S.decode_and_augment

    def half(batch):
        out = decode(batch)
        return {k: v[:max(1, len(v) // 2)] for k, v in out.items()}
    monkeypatch.setattr(S, "decode_and_augment", half)


@pytest.mark.parametrize("cell", ["gan-part1-train", "cnn-finetune-train"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch_mean],
                         ids=["state_unchanged", "half_the_batch"])
def test_training_faults_are_not_correct(tiny_run, monkeypatch, cell, fault):
    fault(monkeypatch)
    result, _ = tiny_run(cell)
    assert result["correct"] is False
