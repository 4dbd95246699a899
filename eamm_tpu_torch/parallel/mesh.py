"""Device meshes and data parallelism (PyTorch).

Counterpart of ``eamm_tpu/parallel/mesh.py``.  JAX has one SPMD idiom for
both of the package's parallel uses, a named mesh whose ``data`` axis XLA
shards; PyTorch has two, and the port uses each where it fits:

- **Rendering: one process over an ordered list of devices** (``Mesh``),
  what JAX's ``EammPipeline.use_mesh`` is.  The batched routes split the
  identities into contiguous shards, one per device, each rendered by that
  device's replica of the models (``replicate_tree``), the payloads joined
  in identity order; with ``time_shard`` each decode chunk's frames split
  over the devices instead.  A mesh of ``["cpu", "cpu"]`` runs the same
  split on the CPU.
- **Training: one process per device on ``torch.distributed``** (NCCL on
  the card, gloo on the CPU).  Each process loads its own slice of the
  batch stream (``DataLoader(shard=(rank, world_size))``), every process
  draws the same model state from the same seed (checked once with
  ``check_replicated``), the BatchNorm layers that normalize with batch
  statistics take them over the global batch (``sync_batchnorm``: the
  JAX mesh's SyncBN), and the gradients are all-reduced to their mean
  before the optimizer step (``all_reduce_grads``).

``make_mesh``, ``host_cpu_mesh`` and ``replicate_tree`` keep the JAX
names.  JAX's ``shard_batch``, ``shard_stacked_batch`` and
``make_mesh_for_batch`` have no counterpart: training shards through the
loader, one process per device, and the batched routes split identities
by ``split_sizes``, which takes any N.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import threading

import torch
import torch.distributed as dist
import torch.nn as nn


def canonical_device(d) -> torch.device:
    """A device with its index: 'cuda' is the current CUDA device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: an ordered tuple of devices along ``axis_name``.  The
    same device may appear more than once (a CPU mesh)."""
    devices: tuple
    axis_name: str = "data"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(canonical_device(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None, axis_name: str = "data") -> Mesh:
    """1-D mesh over every CUDA device (or the given devices)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(tuple(devices), axis_name)


def host_cpu_mesh(n_devices: int, axis_name: str = "data") -> Mesh:
    """A mesh of ``n_devices`` CPU entries (tests and dry runs); JAX needs
    ``--xla_force_host_platform_device_count`` for it, PyTorch nothing."""
    return Mesh(("cpu",) * n_devices, axis_name)


def device_context(device: torch.device):
    """Make ``device`` the current CUDA device for the block, so that the
    port's kernels launch there (their C launchers take the current
    device); a no-op for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def split_sizes(n: int, parts: int) -> list[int]:
    """``n`` rows in ``parts`` contiguous shards as even as can be, the
    larger ones first (``np.array_split``'s sizes)."""
    q, r = divmod(n, parts)
    return [q + (i < r) for i in range(parts)]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def replicate_tree(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` (tensors or modules) per device of ``mesh``:
    the tree itself where it already lies on that device, else a deep copy
    moved there."""
    def on(x, d):
        if isinstance(x, nn.Module):
            p = next(iter(x.parameters()), None)
            here = p is None or canonical_device(p.device) == d
            return x if here else copy.deepcopy(x).to(d)
        return torch.as_tensor(x).to(d)
    return [_map(tree, lambda x, d=d: on(x, d)) for d in mesh.devices]


# ------------------------------------------------------------ training

def torchrun_env(env=None) -> dict | None:
    """torchrun's variables -> {'rank', 'world_size', 'local_rank',
    'init_method'}, or None when ``RANK`` and ``WORLD_SIZE`` are not both
    set (a single-process run)."""
    env = os.environ if env is None else env
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    addr = env.get("MASTER_ADDR", "127.0.0.1")
    port = env.get("MASTER_PORT", "29500")
    return {"rank": int(env["RANK"]), "world_size": int(env["WORLD_SIZE"]),
            "local_rank": int(env.get("LOCAL_RANK", env["RANK"])),
            "init_method": f"tcp://{addr}:{port}"}


def init_distributed(rank: int, world_size: int, init_method: str,
                     device) -> None:
    """Join the process group: NCCL for a CUDA ``device``, gloo for the
    CPU.  Call before the models are built, so that every rank's first
    collective (``check_replicated``) finds the others there."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(canonical_device(device))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world_size)


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_and_size() -> tuple[int, int]:
    """(rank, world size); (0, 1) outside a distributed run."""
    if not is_distributed():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks (``t`` itself outside a
    distributed run)."""
    if not is_distributed():
        return t
    out = t.clone()
    dist.all_reduce(out)
    return out / dist.get_world_size()


def any_rank(flag: bool, device) -> bool:
    """True on every rank when ``flag`` is true on any."""
    if not is_distributed():
        return flag
    t = torch.tensor([float(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_reduce_grads(parameters) -> None:
    """Replace each parameter's ``.grad`` by its mean over the ranks: one
    all-reduce per dtype over the gradients flattened together.  Every
    rank holds the same parameters with gradients (same models, same
    graph), so the buffers line up."""
    if not is_distributed():
        return
    world = dist.get_world_size()
    groups: dict = {}
    for p in parameters:
        if p.grad is not None:
            groups.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in groups.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= world
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def checksum(modules: dict) -> float:
    """A float64 digest of every parameter and buffer of ``modules``, in
    name order, position-weighted so that swapped tensors change it."""
    total = 0.0
    i = 0
    for name in sorted(modules):
        for _, t in sorted(modules[name].state_dict().items()):
            if torch.is_tensor(t) and t.numel():
                i += 1
                v = t.detach().double()
                total += i * float(v.sum()) + float(v.square().sum())
    return total


def check_replicated(modules: dict, device) -> None:
    """Raise on every rank unless all ranks hold the same model state
    (``checksum``): one all-reduce of (digest, -digest) by MAX, which
    gives every rank the largest and the smallest digest.  JAX's
    ``replicate_tree`` holds this by construction; here it is checked."""
    if not is_distributed():
        return
    c = checksum(modules)
    t = torch.tensor([c, -c], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    hi, lo = float(t[0]), -float(t[1])
    if hi != lo:
        raise RuntimeError(f"rank {dist.get_rank()}: the ranks' model "
                           f"states differ (checksums {lo!r} .. {hi!r}); "
                           "every rank must draw them from the same seed")


_local = threading.local()       # .on: inside local_statistics()


@contextlib.contextmanager
def local_statistics():
    """Inside the block (on this thread) ``GlobalBatchNorm2d`` takes its
    batch statistics over this rank's batch alone: for work one rank does
    without the others (the checkpoint's diagnostic image)."""
    was, _local.on = getattr(_local, "on", False), True
    try:
        yield
    finally:
        _local.on = was


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, differentiable: its gradient is the sum of
    the ranks' output gradients (``nn.SyncBatchNorm``'s backward)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out)
        return out


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose batch statistics are taken over the global
    batch of a distributed run (``sync_batchnorm`` turns a module's
    BatchNorm2d layers into this class in place; same state_dict).

    With batch statistics (training mode, or running statistics set aside
    by ``train.steps.batch_statistics``) each rank sums its count, the sum
    and the sum of squares of ``x - shift`` per channel and all-reduces
    the three in one call, differentiably, so the backward all-reduces the
    gradients of those sums as ``nn.SyncBatchNorm`` does.  ``shift`` is the
    running mean, the same on every rank, which keeps the float32 sum of
    squares from cancelling when the mean is large against the spread
    (zero where the running statistics are set aside).  The running
    statistics move as ``nn.BatchNorm2d``'s do: momentum, the unbiased
    variance of the global batch.  ``nn.SyncBatchNorm`` is not used since
    it refuses CPU tensors, so gloo could not run it.  In eval mode, or
    outside a distributed run, it is ``nn.BatchNorm2d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch_stats = self.training or self.running_mean is None
        if (not batch_stats or getattr(_local, "on", False)
                or not is_distributed()):
            return super().forward(x)
        dt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dt)
        C = xf.shape[1]
        shift = (self.running_mean.detach().to(dt)
                 if self.running_mean is not None
                 else xf.new_zeros(C))
        d = xf - shift[None, :, None, None]
        count = xf.new_full((1,), float(xf.numel() // C))
        sums = _AllReduceSum.apply(torch.cat([d.sum((0, 2, 3)),
                                              (d * d).sum((0, 2, 3)), count]))
        n = sums[-1]
        mean_d = sums[:C] / n
        var = sums[C:2 * C] / n - mean_d * mean_d
        mean = shift + mean_d
        if self.training and self.running_mean is not None:
            self.num_batches_tracked.add_(1)
            m = (1.0 / float(self.num_batches_tracked)
                 if self.momentum is None else self.momentum)
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(m * mean.detach())
                self.running_var.mul_(1 - m).add_(
                    m * var.detach() * n / (n - 1))
        y = (xf - mean[None, :, None, None]) * torch.rsqrt(
            var + self.eps)[None, :, None, None]
        if self.affine:
            y = y * self.weight.to(dt)[None, :, None, None] \
                + self.bias.to(dt)[None, :, None, None]
        return y.to(x.dtype)


def sync_batchnorm(module: nn.Module) -> nn.Module:
    """Turn every ``nn.BatchNorm2d`` of ``module`` into a
    ``GlobalBatchNorm2d`` in place (the class only: parameters, buffers
    and state_dict keys stay) and return ``module``."""
    for m in module.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = GlobalBatchNorm2d
    return module


__all__ = ["Mesh", "canonical_device", "make_mesh", "host_cpu_mesh",
           "device_context", "split_sizes", "replicate_tree",
           "torchrun_env", "init_distributed", "is_distributed",
           "rank_and_size", "barrier", "all_reduce_mean", "any_rank",
           "all_reduce_grads", "checksum", "check_replicated",
           "local_statistics", "GlobalBatchNorm2d", "sync_batchnorm"]
