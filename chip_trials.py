#!/usr/bin/env python3
"""Trial builds of two kernels, timed in turns on one NVIDIA GPU.

Run from the repository root: ``python3 chip_trials.py GROUP [GROUP ...]``
with the groups below.  A trial is a copy of one ``csrc/*.cu`` source
with named text edits, each of which must apply (or the group stops),
compiled with the package's nvcc flags into ``build/trials/`` (one nvcc
each, all started together; a trial that does not build is reported and
left out).  For each trial it prints ptxas's registers, spills and
shared memory of the kernel it changes, and its device ms per launch by
CUDA-graph replay, taken in turns with the others of its group
(``chip_smoke.in_turns``: median, min and max of 12 samples, 6 in
k2b-parent).  Each group prints one JSON line.  It needs one CUDA device
and ``nvcc``; it imports nothing of JAX.

Groups:

- ``k2b-parent``: K2b's parent design (one thread a pixel, scalar loads;
  ``--csrc`` the parent's ``eamm_tpu_torch/csrc``, e.g. unpacked by
  ``git archive 838cebb eamm_tpu_torch/csrc | tar -x -C build/parent``)
  at f32 [24,64,64,3] by [264,64,64,2], group 11, grid gradient alone,
  with one part left out at a time: the grid's loads (coordinates made
  from the pixel index), grad_out's loads, the source gathers, the
  stores, and all four; both gradients; the image gradient alone; and the
  store-only kernel over grad_grid's bytes.  Called through the parent's C
  interface.
- ``k6-parent``: K6's parent design (``--csrc`` the parent's csrc) at
  its own shape, bf16 [1,64,64,256] by bf16 [128,64,64,2], grid
  U(-1.05, 1.05), with K1 on the same inputs and the store-only kernel,
  as it is and with edits: the rounding left out, the four corner loads
  hoisted ahead of the arithmetic, the roundings paired, 40 registers,
  the pair loop unrolled twice, and combinations; each held bitwise to
  its plain version (but the trial that leaves the rounding out).
- ``k6``: the tree's K6 beside the parent's (``--parent``) and beside
  edits of the tree's, in the same turns with K1 and the store-only
  kernel, each held bitwise to its plain version.
- ``k2b``: the tree's K2b, first held to its plain version in every
  phase-3b case of chip_smoke.py, then at the timing shape (random and
  near-identity grids; the grid gradient, both, the image gradient) in
  turns with its trial edits (``cluster16`` with plans made for clusters
  of up to 16 blocks, non-portable) and the parent's design
  (``--parent``, the parent's csrc, called through its C interface).
- ``k2b-captured``: K2b's grid gradient at the fine-tune step's own
  arguments (captured from a two-step fine-tune run at the published
  widths; grad_out arrives a plane a channel) and at a near-identity
  grid: the tree's and its vector_runs edit on the arguments as they are
  and made contiguous, the parent's on the contiguous ones, the copy that
  makes grad_out contiguous, and aten's grid_sampler_2d_backward, in
  turns, with where each grid samples.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from eamm_tpu_torch import kernels
from eamm_tpu_torch.ops import warp_cuda

TRIAL_DIR = Path(__file__).resolve().parent / "build" / "trials"
_BUILDS = itertools.count()

# --------------------------------------------------------------- K6 edits

K6_LOOP_OLD = """#pragma unroll
      for (int col = 0; col < 2; ++col) {
        float p[2][VEC];
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          const int off = s_src[q][2 * row + col];
          float val[VEC];
          if (off >= 0)
            unpack(__ldg(reinterpret_cast<const uint4*>(s + off + c0)), val,
                   T());
          const float w = s_wgt[q][2 + row];
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            p[row][j] = off >= 0 ? __fmul_rn(w, val[j]) : 0.f;
        }"""
# the four corners' loads issued before any arithmetic; a corner outside
# the image reads as zeros, whose product with a tent (>= 0) is +0, as
# the select it replaces gives
K6_HOIST = """uint4 raw[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int off = s_src[q][c];
        raw[c] = off >= 0 ? __ldg(reinterpret_cast<const uint4*>(s + off + c0))
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int col = 0; col < 2; ++col) {
        float p[2][VEC];
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          float val[VEC];
          unpack(raw[2 * row + col], val, T());
          const float w = s_wgt[q][2 + row];
#pragma unroll
          for (int j = 0; j < VEC; ++j) p[row][j] = __fmul_rn(w, val[j]);
        }"""
K6_ROUND_OLD = """#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float r = __bfloat162float(
              __float2bfloat16_rn(__fadd_rn(p[0][j], p[1][j])));
          term[col][j] = __fmul_rn(wx, r);
        }"""
K6_NO_ROUND = """#pragma unroll
        for (int j = 0; j < VEC; ++j)
          term[col][j] = __fmul_rn(wx, __fadd_rn(p[0][j], p[1][j]));"""
# two rows rounded by one cvt.rn.bf16x2.f32, widened back by shifts
K6_PAIRS = """#pragma unroll
        for (int j = 0; j < VEC; j += 2) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(
              __fadd_rn(p[0][j], p[1][j]), __fadd_rn(p[0][j + 1], p[1][j + 1]));
          const unsigned u = *reinterpret_cast<const unsigned*>(&h);
          term[col][j] = __fmul_rn(wx, __uint_as_float(u << 16));
          term[col][j + 1] = __fmul_rn(wx, __uint_as_float(u & 0xffff0000u));
        }"""
# a bfloat16 tent times a bfloat16 value is exact in float32, so the
# row's rounded sum of two products is one FMA over the first product
K6_FMA_PRODUCT_OLD = "for (int j = 0; j < VEC; ++j) p[row][j] = __fmul_rn(w, val[j]);"
K6_FMA_PRODUCT = ("for (int j = 0; j < VEC; ++j)\n"
                  "            p[row][j] = sizeof(T) == 2 && row == 1\n"
                  "                ? fmaf(w, val[j], p[0][j]) : __fmul_rn(w, val[j]);")
K6_FMA_SUM = ("sizeof(T) == 2 ? p[1][j] : __fadd_rn(p[0][j], p[1][j]), "
              "sizeof(T) == 2 ? p[1][j + 1] : __fadd_rn(p[0][j + 1], p[1][j + 1]));")
K6_PAIRS_SUM = ("__fadd_rn(p[0][j], p[1][j]), "
                "__fadd_rn(p[0][j + 1], p[1][j + 1]));")
K6_LOOP_UNROLL_OLD = """#pragma unroll 1
  for (int k = t; k < pairs; k += kWideThreads) {"""
K6_LOOP_UNROLL2 = """#pragma unroll 2
  for (int k = t; k < pairs; k += kWideThreads) {"""
K6_BOUNDS_OLD = "__global__ void __launch_bounds__(kWideThreads)\nwarp_wide_kernel"


def k6_edits() -> dict:
    hoist = (K6_LOOP_OLD, K6_HOIST)
    pairs = (K6_ROUND_OLD, K6_PAIRS)
    pairs_fma = (K6_ROUND_OLD, K6_PAIRS.replace(K6_PAIRS_SUM, K6_FMA_SUM))
    fma = (K6_FMA_PRODUCT_OLD, K6_FMA_PRODUCT)
    return {
        "no_round": [(K6_ROUND_OLD, K6_NO_ROUND)],
        "hoist": [hoist],
        "pairs": [pairs],
        "regs40": [(K6_BOUNDS_OLD, K6_BOUNDS_OLD.replace(
            "(kWideThreads)", "(kWideThreads, 6)"))],
        "two_vectors": [(K6_LOOP_UNROLL_OLD, K6_LOOP_UNROLL2)],
        "hoist_pairs": [hoist, pairs],
        "hoist_pairs_fma": [hoist, fma, pairs_fma],
        "hoist_pairs_fma_regs40": [hoist, fma, pairs_fma, (
            K6_BOUNDS_OLD, K6_BOUNDS_OLD.replace("(kWideThreads)",
                                                 "(kWideThreads, 6)"))],
    }


# ------------------------------------------------------ K2b parent's edits

K2B_CORNERS_OLD = ("corners(to_float(g2[0]), to_float(g2[1]), H, W, align, "
                   "idx, wgt, dwx, dwy);\n    const T* go")
K2B_GOUT_OLD = "g[j] = j < C ? to_float(go[j]) : 0.f;"
K2B_GATHER_OLD = "dot = fmaf(g[j], to_float(__ldg(src_s + off + j)), dot);"
K2B_STORE_OLD = """      o[0] = from_float<G>(ax * fx);
      o[1] = from_float<G>(ay * fy);"""


def k2b_parent_edits() -> dict:
    no_grid = (K2B_CORNERS_OLD, K2B_CORNERS_OLD.replace(
        "to_float(g2[0]), to_float(g2[1])",
        "(float)(p & 63) * 0.031f - 0.98f, (float)((p >> 6) & 63) * 0.031f "
        "- 0.98f"))
    no_gout = (K2B_GOUT_OLD, "g[j] = j < C ? 0.5f + 0.125f * j : 0.f;")
    no_gather = (K2B_GATHER_OLD,
                 "dot = fmaf(g[j], (float)(off + j) * 1e-4f, dot);")
    no_store = (K2B_STORE_OLD, "      if (ax == 1234.5f) {\n" + K2B_STORE_OLD
                + "\n      }")
    return {"no_grid_load": [no_grid], "no_gout_load": [no_gout],
            "no_gather": [no_gather], "no_store": [no_store],
            "none_of_them": [no_grid, no_gout, no_gather, no_store]}


# ------------------------------------------------------------- K2b's edits

K2B_THREADS_OLD = "constexpr int kNarrowThreads = IMG ? 512 : 256;"
K2B_BOUNDS_OLD = "__launch_bounds__(kNarrowThreads<IMG>, IMG ? 2 : 1)"
K2B_STAGE_OLD = """  if constexpr (GRD) {
    for (int i = threadIdx.x; i < end / 16; i += kThreads)
      reinterpret_cast<uint4*>(staged)[i] =
          __ldg(reinterpret_cast<const uint4*>(from) + i);
    for (int i = end / 16 * 16 + threadIdx.x; i < end; i += kThreads)
      staged[i] = from[i];
  }
  if constexpr (IMG) {
    for (int i = threadIdx.x; i < HWC; i += kThreads) part[i] = 0.f;
  }
  __syncthreads();
"""
# the source as one bulk copy (cp.async.bulk) that thread 0 issues,
# completed on an mbarrier, the last < 16 bytes by the threads
K2B_BULK = r"""  __shared__ __align__(8) uint64_t bar;
  const unsigned bar_at = (unsigned)__cvta_generic_to_shared(&bar);
  const unsigned body = (unsigned)(end / 16 * 16);
  if constexpr (GRD) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(bar_at) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar_at), "r"(body) : "memory");
      if (body != 0u)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];"
            :: "r"((unsigned)__cvta_generic_to_shared(staged)), "l"(from),
               "r"(body), "r"(bar_at) : "memory");
    }
    for (int i = end / 16 * 16 + threadIdx.x; i < end; i += kThreads)
      staged[i] = from[i];
  }
  if constexpr (IMG) {
    for (int i = threadIdx.x; i < HWC; i += kThreads) part[i] = 0.f;
  }
  __syncthreads();
  if constexpr (GRD) {
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done) : "r"(bar_at), "r"(0u) : "memory");
  }
"""
K2B_ALLOW_OLD = ("        warp_narrow_backward_kernel<T, G, CC, IMG, GRD>, "
                 "kMaxSmem, attributed);")
K2B_ALLOW_SMEM_OLD = K2B_ALLOW_OLD + "\n    device = attributed;"
K2B_PIXELS_OLD = "constexpr int kNarrowPixels = 4;"
K2B_GOUT_LOAD_OLD = "to_float(__ldg(e + j * step))"
K2B_XY_LOAD_OLD = "  return __ldg(reinterpret_cast<const float2*>(g));"
K2B_KERNEL_DOC = "// K2b: persistent blocks, block (x, s) for source s, whose grids' pixels"
K2B_LANES_OLD = """  for (int p0 = blockIdx.x * kTile + threadIdx.x; p0 < n_px;
       p0 += gridDim.x * kTile) {
    float2 xy[kNarrowPixels];
    float g[kNarrowPixels][8];
#pragma unroll
    for (int u = 0; u < kNarrowPixels; ++u) {
      const int p = p0 + u * kThreads;
      if (p >= n_px) continue;
      xy[u] = load_xy(gr + 2 * p);
      const T* e = at(p);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        g[u][j] = j < C ? to_float(__ldg(e + j * step)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kNarrowPixels; ++u) {
      const int p = p0 + u * kThreads;
      if (p >= n_px) continue;
      const float2 d = narrow_pixel<T, IMG, GRD>(xy[u].x, xy[u].y, g[u], C,
                                                 img, part, H, W, align, fx,
                                                 fy);
      if constexpr (GRD) store_xy(gg + 2 * p, d);
    }
  }
"""
# the design before it: a lane a run of 16 bytes of one channel's pixels
# (4 float32, 8 bfloat16), counted from the run of the source's first
# pixel; a whole run's grad_out and (x, y) as 16-byte loads and its grid
# gradient as 16-byte stores (NHWC contiguous grad_out), the rest pixel
# by pixel
K2B_RUN_HELPERS = """template <typename T>
constexpr int kNarrowPpt = 16 / (int)sizeof(T);

template <typename T, typename G, int CC>
struct NarrowRun {
  static constexpr int kOut = CC > 0 ? CC : 1;
  static constexpr int kGrid = kNarrowPpt<T> * 2 * (int)sizeof(G) / 16;
  uint4 out[kOut];
  uint4 grid[kGrid];
};

template <typename T, typename G, int CC, bool IMG, bool GRD>
__device__ __forceinline__ void narrow_run(const NarrowRun<T, G, CC>& v,
                                           const T* img, float* part, G* gg,
                                           int H, int W, int align, float fx,
                                           float fy) {
  constexpr int PPT = kNarrowPpt<T>;
  const T* ov = reinterpret_cast<const T*>(v.out);
  const G* gv = reinterpret_cast<const G*>(v.grid);
  uint4 vec[NarrowRun<T, G, CC>::kGrid];
  G* const res = reinterpret_cast<G*>(vec);
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    float g[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) g[j] = j < CC ? to_float(ov[i * CC + j]) : 0.f;
    const float2 d = narrow_pixel<T, IMG, GRD>(
        to_float(gv[2 * i]), to_float(gv[2 * i + 1]), g, CC, img, part, H, W,
        align, fx, fy);
    res[2 * i] = from_float<G>(d.x);
    res[2 * i + 1] = from_float<G>(d.y);
  }
  if constexpr (GRD) {
    uint4* q = reinterpret_cast<uint4*>(gg);
#pragma unroll
    for (int k = 0; k < NarrowRun<T, G, CC>::kGrid; ++k) __stcs(q + k, vec[k]);
  }
}

"""
K2B_RUNS = """  {
    constexpr int PPT = kNarrowPpt<T>;
    using Run = NarrowRun<T, G, CC>;
    const long long a0 = lo / PPT * PPT;
    const int head = (int)(lo - a0);
    const int runs = (head + n_px + PPT - 1) / PPT;
    const T* const go0 = gout + a0 * C;
    const G* const gr0 = grid + a0 * 2;
    G* const gg0 = GRD ? ggrid + a0 * 2 : nullptr;
    Run run;
    for (int r = blockIdx.x * kThreads + threadIdx.x; r < runs;
         r += gridDim.x * kThreads) {
      if (CC > 0 && lay.dense && r * PPT >= head &&
          r * PPT + PPT <= head + n_px) {
        const uint4* o = reinterpret_cast<const uint4*>(go0 + r * PPT * C);
#pragma unroll
        for (int k = 0; k < Run::kOut; ++k) run.out[k] = __ldcs(o + k);
        const uint4* q = reinterpret_cast<const uint4*>(gr0 + r * PPT * 2);
#pragma unroll
        for (int k = 0; k < Run::kGrid; ++k) run.grid[k] = __ldcs(q + k);
        narrow_run<T, G, CC, IMG, GRD>(run, img, part, gg0 + r * PPT * 2, H,
                                       W, align, fx, fy);
        continue;
      }
#pragma unroll 1
      for (int i = 0; i < PPT; ++i) {
        const int p = r * PPT + i - head;   // the pixel within the source
        if (p < 0 || p >= n_px) continue;
        float g[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) g[j] = j < C ? to_float(at(p)[j * step]) : 0.f;
        const float2 d = narrow_pixel<T, IMG, GRD>(
            to_float(gr[2 * p]), to_float(gr[2 * p + 1]), g, C, img, part, H,
            W, align, fx, fy);
        if constexpr (GRD) store_xy(gg + 2 * p, d);
      }
    }
  }
"""


def k2b_edits() -> dict:
    """Edits of the tree's K2b: the source staged by one bulk copy
    (cp.async.bulk on an mbarrier) instead of the threads' 16-byte loads;
    256 threads a block with the image gradient (the plan's blocks
    unchanged, so each walks twice the tiles); 512 without; registers
    capped for four or three blocks an SM without the image gradient;
    eight pixels a thread at once; grad_out and the grid read with
    evict-first loads (ld.global.cs); the design before the tree's, a
    lane a run of 16 bytes of a channel's pixels moved as 16-byte
    vectors (``vector_runs``); clusters of up to 16 blocks."""
    return {
        "bulk_copy": [(K2B_STAGE_OLD, K2B_BULK),
                      (K2B_ALLOW_OLD, K2B_ALLOW_OLD.replace(
                          "kMaxSmem,", "kMaxSmem - 16,"))],
        "image_threads256": [(K2B_THREADS_OLD, K2B_THREADS_OLD.replace(
            "512", "256"))],
        "grid_threads512": [(K2B_THREADS_OLD, K2B_THREADS_OLD.replace(
            "256", "512"))],
        "grid_bounds4": [(K2B_BOUNDS_OLD, K2B_BOUNDS_OLD.replace(
            "IMG ? 2 : 1", "IMG ? 2 : 4"))],
        "grid_bounds3": [(K2B_BOUNDS_OLD, K2B_BOUNDS_OLD.replace(
            "IMG ? 2 : 1", "IMG ? 2 : 3"))],
        "eight_pixels": [(K2B_PIXELS_OLD, K2B_PIXELS_OLD.replace("4", "8"))],
        "streaming_loads": [
            (K2B_GOUT_LOAD_OLD, K2B_GOUT_LOAD_OLD.replace("__ldg", "__ldcs")),
            (K2B_XY_LOAD_OLD, K2B_XY_LOAD_OLD.replace("__ldg", "__ldcs"))],
        "vector_runs": [(K2B_KERNEL_DOC, K2B_RUN_HELPERS + K2B_KERNEL_DOC),
                        (K2B_LANES_OLD, K2B_RUNS)],
        # clusters of up to 16 blocks (non-portable), timed with plans
        # made for them (``cluster_limit``)
        "cluster16": [
            ("(gsrc && blocks > 8)", "(gsrc && blocks > 16)"),
            (K2B_ALLOW_SMEM_OLD, K2B_ALLOW_SMEM_OLD.replace(
                "    device = attributed;",
                "    static bool wide = false;  // once, before any capture\n"
                "    if (IMG && err == cudaSuccess && !wide)\n"
                "      wide = cudaFuncSetAttribute(\n"
                "          warp_narrow_backward_kernel<T, G, CC, IMG, GRD>,\n"
                "          cudaFuncAttributeNonPortableClusterSizeAllowed,\n"
                "          1) == cudaSuccess;\n"
                "    device = attributed;"))],
    }


# ------------------------------------------------------------------ harness

def build_trials(source: Path, trials: dict) -> dict:
    """name -> (library, ptxas report) for each trial of ``source``."""
    TRIAL_DIR.mkdir(parents=True, exist_ok=True)
    text = source.read_text()
    started = {}
    for name, edits in trials.items():
        edited = text
        for old, new in edits:
            if old not in edited:
                raise SystemExit(f"trial {name}: an edit does not apply to "
                                 f"{source}:\n{old}")
            edited = edited.replace(old, new)
        # a name of its own each build: a library that is loaded must not
        # be written over, and dlopen hands back a loaded path's handle
        path = TRIAL_DIR / f"{source.stem}-{name}-{next(_BUILDS)}.cu"
        path.write_text(edited)
        lib = path.with_suffix(".so")
        started[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in started.items():
        out, _ = proc.communicate()
        if proc.returncode:             # the group goes on without it
            errors = [line for line in out.splitlines() if "error" in line]
            print(json.dumps({"trial": name, "nvcc_failed": list(
                dict.fromkeys(errors))[:20]}), flush=True)
            if name in ("tree", "parent"):
                raise SystemExit(f"trial {name}: nvcc failed")
            continue
        handle = ctypes.CDLL(str(lib))
        handle.eamm_error_string.argtypes = [ctypes.c_int]
        handle.eamm_error_string.restype = ctypes.c_char_p
        built[name] = (handle, out)
    return built


def ptxas_of(report: str, *kernels: str) -> list:
    """ptxas's register, spill and shared-memory lines of the kernels whose
    mangled names hold one of ``kernels``."""
    lines = report.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and any(k in line
                                                      for k in kernels):
            name = re.search(r"'(\S+)'", line).group(1)
            facts = [lines[j].split(" : ")[-1].strip()
                     for j in range(i + 1, min(i + 6, len(lines)))
                     if "Used" in lines[j] or "spill" in lines[j]]
            out.append({"symbol": name[-60:], "facts": facts[:2]})
    return out


def use(source: str, lib) -> None:
    """Route the package's calls of ``csrc/<source>.cu`` to ``lib``."""
    kernels._libraries[source] = lib


def k6_parent_group(csrc: Path) -> dict:
    return k6_timed(build_trials(csrc / "warp.cu",
                                 {"tree": [], **k6_edits()}), "k6-parent")


K6_FIXED_OLD = "    if (kWideThreads % vecs == 0) {"
K6_PIXELS_OLD = """#pragma unroll 1
      for (int q = t / vecs; q < n_px; q += kWideThreads / vecs)"""
K6_LOAD_OLD = "? __ldg(reinterpret_cast<const uint4*>(s + off + c0))"
K6_BOUNDS = "__launch_bounds__(kWideThreads, 8)\nwarp_wide_b16_kernel"
K6_OFFS_OLD = ("  const int4 offs = make_int4(taps[0], taps[1], taps[2], "
               "taps[3]);")
K6_WEIGHTS_OLD = "  const float4 w = *reinterpret_cast<const float4*>(weights);"


def k6_tree_edits() -> dict:
    """Edits of the tree's K6: registers not capped; the corners read
    through L2 only (ld.global.cg); a pixel's corner offsets read as one
    16-byte vector; its weights as four scalars; the (pixel, vector) pairs
    walked with a division each, as K1 walks them; two pixels a step
    (the pixel loop unrolled twice), capped and not."""
    return {
        "uncapped": [(K6_BOUNDS, K6_BOUNDS.replace(", 8)", ")"))],
        "ldcg": [(K6_LOAD_OLD, K6_LOAD_OLD.replace("__ldg", "__ldcg"))],
        "vector_offsets": [
            ("  __shared__ int s_src[kWidePix][4];",
             "  __shared__ __align__(16) int s_src[kWidePix][4];"),
            (K6_OFFS_OLD, "  const int4 offs = "
             "*reinterpret_cast<const int4*>(taps);")],
        "scalar_weights": [(K6_WEIGHTS_OLD, "  const float4 w = make_float4("
                            "weights[0], weights[1], weights[2], "
                            "weights[3]);")],
        "division_loop": [(K6_FIXED_OLD, "    if (false) {")],
        "two_pixels": [(K6_PIXELS_OLD, K6_PIXELS_OLD.replace(
            "unroll 1", "unroll 2"))],
        "two_pixels_uncapped": [
            (K6_PIXELS_OLD, K6_PIXELS_OLD.replace("unroll 1", "unroll 2")),
            (K6_BOUNDS, K6_BOUNDS.replace(", 8)", ")"))],
    }


def k6_group(csrc: Path, parent: Path) -> dict:
    """The tree's K6 beside the parent's and beside its own edits."""
    trials = build_trials(csrc / "warp.cu",
                          {"tree": [], **k6_tree_edits()})
    trials.update(build_trials(parent / "warp.cu", {"parent": []}))
    return k6_timed(trials, "k6")


def k6_timed(trials: dict, group: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    image, grid = cs.k6_case(1, cs.K6_B, (64, 64), torch.bfloat16, gen)
    want = warp_cuda.grid_sample_twolevel_b16_plain(image, grid)
    fns, parity = {}, {}
    for name, (lib, _) in trials.items():
        use("warp", lib)
        got = warp_cuda.grid_sample_twolevel_b16(image, grid)
        torch.cuda.synchronize()
        parity[name] = int((got != want).sum().item())
        fns[name] = cs.graphed(
            lambda: warp_cuda.grid_sample_twolevel_b16(image, grid), 8)
    use("warp", trials["tree"][0])
    fns["k1_same_inputs"] = cs.graphed(
        lambda: warp_cuda.grid_sample_wide(image, grid), 8)
    if "parent" in trials:
        use("warp", trials["parent"][0])
        fns["k1_parent"] = cs.graphed(
            lambda: warp_cuda.grid_sample_wide(image, grid), 8)
        use("warp", trials["tree"][0])
    sink = torch.empty_like(want)
    fns["store_only"] = cs.graphed(lambda: warp_cuda.store_only(sink), 8)
    times = cs.in_turns(fns, rounds=6)
    bad = [n for n, d in parity.items() if d and n != "no_round"]
    return {"group": group, "card": cs.card_line(),
            "ms": {k: v for k, v in times.items()}, "differ": parity,
            "not_bitwise": bad,
            "ptxas": {n: ptxas_of(r, *K6_SYMBOLS)
                      for n, (_, r) in trials.items()},
            "k1_ptxas": {n: ptxas_of(r, *K1_SYMBOLS)
                         for n, (_, r) in trials.items()}}


# K6's and K1's bfloat16 instantiations, as their own kernels and as the
# parent design's one template with a B16 flag
K6_SYMBOLS = ("warp_wide_b16_kernelI13__nv_bfloat16S1_E",
              "warp_wide_kernelI13__nv_bfloat16S1_Lb1")
K1_SYMBOLS = ("warp_wide_kernelI13__nv_bfloat16S1_E",
              "warp_wide_kernelI13__nv_bfloat16S1_Lb0")


# the parent's C interface of eamm_warp_narrow_backward: src, grid, gout,
# the float32 accumulator, grad_image, grad_grid, then as ``_WARP_ARGS``
PARENT_K2B_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
    ctypes.c_void_p]


def parent_k2b(lib, args):
    """A call of the parent's K2b on ``args`` (chip_smoke.warp_grad_case's
    tuple, float32): its outputs are made once, outside the timing."""
    grad_out, image, grid, align, need_image, need_grid = args
    gi = torch.empty_like(image) if need_image else None
    gg = torch.empty_like(grid) if need_grid else None
    fn = lib.eamm_warp_narrow_backward
    fn.argtypes, fn.restype = PARENT_K2B_ARGS, ctypes.c_int
    Bi, H, W, C = image.shape
    B, Ho, Wo, _ = grid.shape
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731

    def call():
        code = fn(image.data_ptr(), grid.data_ptr(), grad_out.data_ptr(),
                  ptr(gi), ptr(gi), ptr(gg), 0, 0, B, Ho, Wo, B // Bi, H, W,
                  C, int(align), torch.cuda.current_stream().cuda_stream)
        kernels.check(lib, code, "parent eamm_warp_narrow_backward")
    return call, gg


def k2b_parent_group(csrc: Path) -> dict:
    trials = build_trials(csrc / "warp_backward.cu",
                          {"tree": [], **k2b_parent_edits()})
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {"group": "k2b-parent", "card": cs.card_line(),
           "ptxas": {n: ptxas_of(r, "warp_narrow_backward_kernelIff")
                     for n, (_, r) in trials.items()}}
    for kind in ("random", "near_identity"):
        args = cs.warp_grad_case(24, 264, 3, torch.float32, gen,
                                 need=(False, True), grid=kind)
        fns = {}
        for name, (lib, _) in trials.items():
            call, _ = parent_k2b(lib, args)
            fns[name] = cs.graphed(call)
        base = trials["tree"][0]
        fns["tree_both"] = cs.graphed(
            parent_k2b(base, args[:4] + (True, True))[0])
        fns["tree_image_only"] = cs.graphed(
            parent_k2b(base, args[:4] + (True, False))[0])
        sink = torch.empty_like(args[2])
        fns["store_only_grad_grid"] = cs.graphed(
            lambda: warp_cuda.store_only(sink))
        call, got = parent_k2b(base, args)
        call()
        want = warp_cuda.grid_sample_backward_plain(*args)[1]
        out[kind] = {"ms": cs.in_turns(fns),
                     "tree_grid_errors": cs.grad_errors(got, want)}
    return out


@contextlib.contextmanager
def cluster_limit(n: int):
    """K2b's plans made with clusters of at most ``n`` blocks while in
    use."""
    saved = warp_cuda.NARROW_BACKWARD_CLUSTER
    warp_cuda.NARROW_BACKWARD_CLUSTER = n
    warp_cuda._narrow_launch_plan.cache_clear()
    try:
        yield
    finally:
        warp_cuda.NARROW_BACKWARD_CLUSTER = saved
        warp_cuda._narrow_launch_plan.cache_clear()


def k2b_group(csrc: Path, parent: Path) -> dict:
    trials = build_trials(csrc / "warp_backward.cu",
                          {"tree": [], **k2b_edits()})
    (old, _), = build_trials(parent / "warp_backward.cu",
                             {"parent": []}).values()
    use("warp_backward", trials["tree"][0])
    cases = [c for c in cs.grad_cases() if c[0] == "warp_narrow_backward"]
    worst = cs.grad_parity(cases)["warp_narrow_backward"]
    del cases
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {"group": "k2b", "card": cs.card_line(), "tree_worst": worst,
           "ptxas": {n: ptxas_of(r, "warp_narrow_backward_kernel")
                     for n, (_, r) in trials.items()}}
    for kind in ("random", "near_identity"):
        args = cs.warp_grad_case(24, 264, 3, torch.float32, gen,
                                 need=(False, True), grid=kind)
        want = warp_cuda.grid_sample_backward_plain(*args[:4], True, True)
        fns, errors = {}, {}
        for need in ((False, True), (True, True), (True, False)):
            a = args[:4] + need
            fns[f"parent {need}"] = cs.graphed(parent_k2b(old, a)[0])
            for name, (lib, _) in trials.items():
                if name == "cluster16" and not need[0]:
                    continue
                use("warp_backward", lib)
                with cluster_limit(16 if name == "cluster16" else
                                   warp_cuda.NARROW_BACKWARD_CLUSTER):
                    if need == (True, True):
                        got = warp_cuda.warp_narrow_backward(*a)
                        errors[name] = [cs.grad_errors(g, w)
                                        for g, w in zip(got, want)]
                    fns[f"{name} {need}"] = cs.graphed(
                        lambda a=a: warp_cuda.warp_narrow_backward(*a))
        use("warp_backward", trials["tree"][0])
        out[kind] = {"ms": cs.in_turns(fns, rounds=6), "errors": errors}
    return out


def grid_stats(grid: torch.Tensor, H: int, W: int) -> dict:
    """Where a grid's pixels sample: the pixel coordinates' step from one
    output pixel to the next along a row and down a column (quantiles of
    |step|), and the share of pixels with all four corners inside."""
    x = ((grid[..., 0].float() + 1) * W - 1) * 0.5
    y = ((grid[..., 1].float() + 1) * H - 1) * 0.5
    q = torch.tensor([0.1, 0.5, 0.9], device=grid.device)
    inside = ((x >= 0) & (x <= W - 2) & (y >= 0) & (y <= H - 2)).float()
    return {"row_step": torch.quantile(
                (x[:, :, 1:] - x[:, :, :-1]).abs().flatten()[::7], q).tolist(),
            "column_step": torch.quantile(
                (y[:, 1:] - y[:, :-1]).abs().flatten()[::7], q).tolist(),
            "all_corners_inside": inside.mean().item()}


def k2b_captured_group(csrc: Path, parent: Path) -> dict:
    """K2b at the fine-tune step's own arguments (the first K2b launch of
    a two-step ``train_part1_fine_tune`` run through chip_smoke.py's
    entry point), the grid gradient alone as the path asks: the tree's,
    its vector_runs edit, the parent's and aten's, in turns, beside the
    near-identity grid of chip_smoke.py's phase 6, with each grid's
    ``grid_stats``."""
    trials = build_trials(csrc / "warp_backward.cu", {
        "tree": [], "vector_runs": k2b_edits()["vector_runs"]})
    (old, _), = build_trials(parent / "warp_backward.cu",
                             {"parent": []}).values()
    use("warp_backward", trials["tree"][0])
    captured: dict = {}
    with tempfile.TemporaryDirectory() as work:
        root = os.path.join(work, "lrw")
        cs.write_lrw_tree(root)
        cs.train_entry_point("train_part1_fine_tune", root, work, "cuda",
                             steps=2, backward_args=captured)
    gen = torch.Generator(device="cuda").manual_seed(7)
    inputs = {"captured": captured["warp_narrow_backward"],
              "near_identity": cs.warp_grad_case(
                  24, 264, 3, torch.float32, gen, need=(False, True),
                  grid="near_identity")}
    out = {"group": "k2b-captured", "card": cs.card_line()}
    for kind, args in inputs.items():
        want = warp_cuda.grid_sample_backward_plain(*args)[1]
        grad_out, image, grid, align = args[:4]
        dense = (grad_out.contiguous(), image.contiguous(),
                 grid.contiguous(), *args[3:])
        fns, errors = {}, {}
        # the parent's C interface reads grad_out as NHWC contiguous
        fns["parent"] = cs.graphed(parent_k2b(old, dense)[0])
        for name, (lib, _) in trials.items():
            use("warp_backward", lib)
            for layout, a in (("", args), (" contiguous", dense)):
                errors[name + layout] = cs.grad_errors(
                    warp_cuda.warp_narrow_backward(*a)[1], want)
                fns[name + layout] = cs.graphed(
                    lambda a=a: warp_cuda.warp_narrow_backward(*a))
        use("warp_backward", trials["tree"][0])
        if not grad_out.is_contiguous():    # else a copy is no launch
            fns["copy"] = cs.graphed(lambda: grad_out.contiguous())
        nchw = image.permute(0, 3, 1, 2).repeat_interleave(
            grid.shape[0] // image.shape[0], dim=0)
        gout = grad_out.permute(0, 3, 1, 2)
        fns["library"] = cs.graphed(
            lambda: torch.ops.aten.grid_sampler_2d_backward(
                gout, nchw, grid, 0, 0, align, [False, True]))
        out[kind] = {"ms": cs.in_turns(fns, rounds=6), "errors": errors,
                     "grid": grid_stats(grid, *image.shape[1:3]),
                     "strides": [list(t.stride()) for t in args[:3]],
                     "layout": warp_cuda.narrow_out_layout(grad_out),
                     "shapes": [list(t.shape) for t in args[:3]]}
    return out


GROUPS = {"k6-parent": k6_parent_group, "k6": k6_group,
          "k2b-parent": k2b_parent_group, "k2b": k2b_group,
          "k2b-captured": k2b_captured_group}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("groups", nargs="+", choices=sorted(GROUPS))
    parser.add_argument("--csrc", type=Path, default=kernels.CSRC,
                        help="the csrc directory whose sources are trialled")
    parser.add_argument("--parent", type=Path,
                        default=Path("build/parent/eamm_tpu_torch/csrc"),
                        help="the parent's csrc, which k2b times beside "
                             "the tree's")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_trials: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    os.makedirs(TRIAL_DIR, exist_ok=True)
    print(cs.card_line(), flush=True)
    failed = []
    for group in opts.groups:
        args = (opts.csrc.resolve(),) + (
            (opts.parent.resolve(),)
            if group in ("k2b", "k6", "k2b-captured") else ())
        try:
            print(json.dumps(GROUPS[group](*args)), flush=True)
        except (Exception, SystemExit) as e:   # the next group still runs
            print(json.dumps({"group": group, "failed": str(e)}), flush=True)
            failed.append(group)
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
