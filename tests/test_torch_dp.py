"""The port's data-parallel training (``parallel/mesh.py``) on the CPU:
two spawned gloo processes take one TINY ``train_part1`` step on the two
halves of a global batch of 4 (``tests/torch_dp_worker.py``), in float64
so that only the order of the sums differs, and the all-reduced result is
held to the port's single-process step on the whole batch with
tests/test_torch_train_steps.py's bounds: losses (the ranks' mean) within
LOSS_RTOL, every gradient leaf within GRAD_REL relative L2, the BatchNorm
running statistics within STATS_TOL; the frozen detector's statistics
unchanged; both ranks' gradients and parameters after the step equal; a
rank whose state differs refused on both ranks.  That single-process step
is held to JAX's in tests/test_torch_train_steps.py (JAX's own sharded
check, tests/test_train_steps.py, needs an XLA CPU mesh, which stalls on
this host)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from eamm_tpu_torch.data.datasets import DataLoader
from tests.test_torch_train_steps import GRAD_REL, LOSS_RTOL, STATS_TOL
from tests.torch_dp_worker import digest

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dp_worker.py")
WORLD = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """(each rank's results, the single-process step on the whole batch),
    the latter taken while the ranks run; a rank that fails or hangs fails
    the test."""
    work = tmp_path_factory.mktemp("dp")
    port = chip_smoke.free_port()
    outs = [str(work / f"rank{r}.pt") for r in range(WORLD)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(port), outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(WORLD)]
    try:
        cfg, batch = chip_smoke.step_inputs(0, 4, "cnn", "train_part1",
                                            frames=2)
        single = chip_smoke.step_gradients(cfg, batch, 0, "cpu",
                                           torch.float64, "train_part1")
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [torch.load(o, weights_only=False) for o in outs], single


def test_data_parallel_step_matches_single_process(steps):
    ranks, single = steps
    for k, v in single["metrics"].items():
        mean = np.mean([r["metrics"][k] for r in ranks])
        np.testing.assert_allclose(mean, v, rtol=LOSS_RTOL)
    total = {}
    for k, g in single["grads"].items():
        model = k.split(".")[0]
        total[model] = total.get(model, 0.0) + float((g ** 2).sum())
    worst = 0.0
    for k, g in single["grads"].items():
        assert digest(ranks[0]["grads"][k]) == ranks[1]["grads"][k], k
        floor = max(float(g.norm()),
                    GRAD_REL * total[k.split(".")[0]] ** 0.5)
        err = float((ranks[0]["grads"][k] - g).norm()) / floor
        worst = max(worst, err)
        assert err <= GRAD_REL, f"{k}: relative error {err}"
    print(f"largest relative gradient error {worst:.3g}")
    for k, v in single["stats"].items():
        for r in ranks:
            np.testing.assert_allclose(r["stats"][k].numpy(), v.numpy(),
                                       rtol=STATS_TOL, atol=STATS_TOL)


def test_ranks_stay_replicated(steps):
    """The frozen detector's statistics as drawn, both ranks' parameters
    equal after the optimizer step, and a perturbed rank refused."""
    ranks = steps[0]
    for r in ranks:
        assert r["frozen_unchanged"] and r["mismatch_caught"]
    assert ranks[0]["params"] == ranks[1]["params"]


def test_loader_shards_are_disjoint():
    """``DataLoader(shard=(rank, world))``: the same shuffle on every rank,
    every count-th batch, so the ranks' samples never meet."""
    seen = []
    for rank in range(WORLD):
        loader = DataLoader(list(range(12)), batch_size=2, seed=3,
                            shard=(rank, WORLD))
        seen.append({i for b in loader._batch_indices() for i in b})
    assert seen[0].isdisjoint(seen[1]) and len(seen[0] | seen[1]) == 12
