"""One rank of the port's data-parallel part1 step, spawned by
tests/test_torch_dp.py:

    python tests/torch_dp_worker.py RANK WORLD_SIZE PORT OUT

It joins a gloo group on 127.0.0.1:PORT, takes its contiguous slice of
``chip_smoke.step_inputs``' global batch of 4 (TINY_CONFIG widths,
float64), one ``train_part1`` gradient with BatchNorm over the global
batch and the gradients all-reduced, then one optimizer step, and saves
what the test holds to the single-process step in OUT: the metrics, the
BatchNorm statistics, rank 0's gradients (rank 1's as SHA-256 digests of
their bytes) and every parameter's digest after the step.  It imports torch,
the port and chip_smoke: neither JAX nor tests/conftest.py."""
import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from eamm_tpu_torch.parallel import (check_replicated,  # noqa: E402
                                     init_distributed)
from eamm_tpu_torch.train.loop import build_models  # noqa: E402

GLOBAL_BATCH = 4


def digest(t: torch.Tensor) -> str:
    """The tensor's bytes' SHA-256: equal digests, equal tensors."""
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()


def main(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    init_distributed(rank, world, f"tcp://127.0.0.1:{port}", "cpu")
    cfg, batch = chip_smoke.step_inputs(0, GLOBAL_BATCH, "cnn",
                                        "train_part1", frames=2)
    n = GLOBAL_BATCH // world
    local = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    keep = {}
    side = chip_smoke.step_gradients(cfg, local, 0, "cpu", torch.float64,
                                     "train_part1", synced=True, keep=keep)
    models = keep["state"].models
    drawn = build_models(cfg, "train_part1", False, 0, "cpu")["kp_detector"]
    frozen = all(torch.equal(v, drawn.state_dict()[k].to(v.dtype))
                 for k, v in models["kp_detector"].state_dict().items()
                 if "running" in k or "num_batches" in k)
    keep["state"].optimizer.step()
    params = {f"{name}.{k}": digest(p) for name, m in models.items()
              for k, p in m.named_parameters()}
    check_replicated(models, "cpu")             # equal after the step
    with torch.no_grad():
        if rank == 1:
            next(models["audio_feature"].parameters()).add_(1.0)
    try:
        check_replicated(models, "cpu")
        caught = False
    except RuntimeError:
        caught = True
    if rank:        # rank 0's gradients are held to the single step
        side["grads"] = {k: digest(g) for k, g in side["grads"].items()}
    torch.save({**side, "params": params, "frozen_unchanged": frozen,
                "mismatch_caught": caught}, out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
