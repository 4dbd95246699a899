"""The harness as data: cells, configurations and metrics found by name;
the contract's result line; no JAX, and a reference independent of the
program."""
from __future__ import annotations

import ast
import json
import shutil

import pytest

from perfbench.tests.conftest import ROOT

PERFBENCH = ROOT / "perfbench"
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def imports(path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(PERFBENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_no_jax(path):
    assert not imports(path) & {"jax", "jaxlib", "flax", "eamm_tpu"}


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference").rglob(
    "*.py")), ids=lambda p: p.name)
def test_reference_independent_of_the_program(path):
    assert "eamm_tpu_torch" not in imports(path)


def test_benchmark_names_resolve():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        cell = json.loads((PERFBENCH / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert cell["config"] == w["config"]
        assert (PERFBENCH / "drivers" / f"{cell['driver']}.py").is_file()
        assert all(v is not None for v in cell["check"]["limits"].values())
    for m in bench["per_layer"]:
        assert (PERFBENCH / "metrics" / f"{m['name']}.py").is_file()


def test_a_cell_added_by_files_alone_runs(tmp_path, tiny_run):
    """A copy of the benchmark with one more cell, added by its file and
    by entries alone (the cell, and the cell's name in the metrics that
    list their cells), runs and prints the contract's line."""
    shutil.copytree(PERFBENCH, tmp_path / "perfbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "gan-part1-b4", "config": "eamm-gan", "traffic": "b4-t4",
        "chips": 1, "why": "a smaller part1 batch"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "gan-part1-train" in m.get("workloads", []):
            m["workloads"].append("gan-part1-b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = json.loads((PERFBENCH / "workloads" / "gan-part1-train.json")
                      .read_text())
    cell["traffic"].update(batch=4, frames=4)
    cell["trace"] = {"after_steps": 0, "steps": 1}
    (tmp_path / "perfbench" / "workloads" / "gan-part1-b4.json").write_text(
        json.dumps(cell))
    for trace, want in ((0, {"train_samples_per_s", "setup_s"}),
                        (1, {"train.mfu"})):
        result, _ = tiny_run("gan-part1-b4", trace=trace, root=tmp_path)
        line = json.loads(json.dumps(result))
        assert RESULT_KEYS <= set(line) and list(line)[-1] == "checks"
        assert want <= set(line["metrics"])
        assert line["device"]["count"] == 1
        assert line["attempted"] >= 1 and line["failed"] == 0
        assert line["correct"] is True


def test_main_refuses_without_a_card(monkeypatch, capsys):
    import torch
    from perfbench import harness
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "cnn-serve-closed8", "--seed", "1",
                         "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
