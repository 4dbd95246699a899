"""Build and load the hand-written CUDA kernels of ``eamm_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface.  At first CUDA
use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/kernels/`` at the repository root, named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  The libraries are loaded with ``ctypes``: pointers and
the stream cross as ``ctypes.c_void_p``.  Nothing here runs at import time,
so the package imports on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("warp", "warp_backward", "kp_expectation")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Build:
    """One compiled source: its library path, the seconds nvcc took (0 when
    an earlier build of the same hash was reused) and ptxas's report."""
    name: str
    path: Path
    seconds: float
    ptxas: str


_libraries: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES) -> list[Build]:
    """Compile every stale source in ``names``, one nvcc process per source,
    all started together; raise with nvcc's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, time.perf_counter())
    results = []
    for name in names:
        target = _target(name)
        log = target.with_suffix(".ptxas.txt")
        if name not in started:
            results.append(Build(name, target, 0.0,
                                 log.read_text() if log.exists() else ""))
            continue
        proc, tmp, t0 = started[name]
        output, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{output}")
        log.write_text(output)
        os.replace(tmp, target)
        results.append(Build(name, target, seconds, output))
    return results


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    lib = _libraries.get(name)
    if lib is None:
        (built,) = build((name,))
        lib = ctypes.CDLL(str(built.path))
        lib.eamm_error_string.argtypes = [ctypes.c_int]
        lib.eamm_error_string.restype = ctypes.c_char_p
        _libraries[name] = lib
    return lib


def entry(name: str, function: str, argtypes: list):
    """The loaded library of ``csrc/<name>.cu`` and its C function
    ``function``, given ``argtypes`` and an ``int`` result on its first
    lookup in that library (ctypes keeps one function object per library
    and name, so it is typed once)."""
    lib = library(name)
    fn = getattr(lib, function)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if code != 0:
        msg = lib.eamm_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
