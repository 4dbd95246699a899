"""Copies between the host and the device on CUDA streams of their own
(counterpart of ``eamm_tpu/utils/transfer.py``).

A copy to the host (``Link.fetch_async``) waits, on a copy stream, for an
event recorded on the compute stream after the work that made its tensors,
and copies each of them with one ``non_blocking=True`` copy into a pinned
host staging buffer; the compute stream goes on with later work meanwhile.
Each source tensor is marked as used on the copy stream
(``record_stream``) and referenced until the copy is done, so the caching
allocator cannot hand its memory to later work while the copy reads it.
``HostFetch.result`` waits for the copy's event and hands out pageable
numpy copies of the staging buffers, which it then drops: they go back to
PyTorch's caching host allocator for the next copy, so the page-locked
memory a process holds is that of the copies in flight, not of the results
its caller keeps.

A copy to the device (``Link.upload``) goes through pinned memory on a
second stream; the compute stream waits for it only where the work that
reads it is queued, so earlier work overlaps the copy.

On the CPU both are plain copies.
"""
from __future__ import annotations

import numpy as np
import torch


class HostFetch:
    """A copy to the host in flight; ``result()`` waits for it."""

    def __init__(self, buffers: list, done=None, sources=None):
        self._buffers = buffers
        self._done = done
        self._sources = sources

    def result(self) -> tuple:
        """The copied tensors as numpy arrays, once the copy is complete."""
        if self._done is not None:
            self._done.synchronize()
            # pageable copies, made by PyTorch's threaded copy: the page
            # faults of a fresh 49 MB array made a one-thread numpy copy
            # twice as slow on an H100 host; the pinned staging buffers
            # are dropped here
            self._buffers = [torch.empty(b.shape, dtype=b.dtype).copy_(b)
                             for b in self._buffers]
            self._done = self._sources = None
        return tuple(b.numpy() for b in self._buffers)


class Link:
    """The copy streams between the host and one device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._fetch = self._upload = None
        if self.device.type == "cuda":
            self._fetch = torch.cuda.Stream(self.device)
            self._upload = torch.cuda.Stream(self.device)

    def fetch_async(self, tensors, keep: int | None = None,
                    axis: int = 0) -> HostFetch:
        """Start copying ``tensors`` (each cut to its first ``keep``
        entries along ``axis``) to the host."""
        tensors = tuple(tensors)
        if keep is not None:
            tensors = tuple(t.narrow(axis, 0, keep) for t in tensors)
        if self._fetch is None:
            return HostFetch([t.clone(memory_format=torch.contiguous_format)
                              for t in tensors])
        # a copy into pinned memory needs a contiguous source; make it
        # where the tensor was made
        tensors = tuple(t.contiguous() for t in tensors)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        buffers = []
        with torch.cuda.stream(self._fetch):
            self._fetch.wait_event(ready)
            for t in tensors:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                t.record_stream(self._fetch)
                buffers.append(buf)
            done = torch.cuda.Event()
            done.record(self._fetch)
        return HostFetch(buffers, done, tensors)

    def fetch(self, tensors, keep: int | None = None, axis: int = 0) -> tuple:
        """``fetch_async(...).result()``."""
        return self.fetch_async(tensors, keep, axis).result()

    def upload(self, array: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the device.  On CUDA the copy runs
        from pinned memory on the upload stream, and the current stream
        waits for it before any work queued after this call."""
        host = torch.as_tensor(np.ascontiguousarray(array))
        if self._upload is None:
            return host.to(self.device)
        host = host.pin_memory()
        with torch.cuda.stream(self._upload):
            out = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._upload)
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(done)
        out.record_stream(compute)
        return out
