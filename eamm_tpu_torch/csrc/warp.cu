// Bilinear grid_sample (zeros padding) for NVIDIA Hopper.
//
// Replaces the TPU kernels of eamm_tpu/ops/warp_pallas.py:
//   warp_wide   <- grid_sample_twolevel_pallas / _twolevel_kernel (wide C,
//                  the generator's bottleneck warp, [1,64,64,256] source)
//   warp_narrow <- grid_sample_smallc_pallas / _smallc_kernel (C <= 8, dense
//                  motion's K+1 deformed copies of the [1,64,64,3] source)
//   warp_shared <- grid_sample_shared / _warp_kernel (one [Hs,Ws,C] source
//                  by N grids, any C): warp_wide's kernel when C % 8 == 0,
//                  else warp_groups_kernel
// and the TPU kernel of benchmarks/bench_warp_variants.py:
//   warp_wide_b16 <- twolevel_b16 / _twolevel_kernel_b16 (warp_wide's
//                  warp with its y pass rounded to bfloat16, see below)
// The TPU kernels factor the sample into tent-matrix or one-hot-matrix
// products because the TPU has no per-lane gather.  The GPU gathers
// natively, so the kernels here read the four corners directly.
//
// Semantics: image [Bi,H,W,C] NHWC, grid [B,Ho,Wo,2] (x, y) in [-1,1],
// each float32 or bfloat16; grid b samples image b / (B / Bi).  The
// coordinates, the four corner weights and the sum are float32; the result
// is rounded once to the image type.  A corner outside the image has
// weight 0.
//
// warp_narrow.  At dense motion's shapes (bf16 [1,64,64,3] by
// [352,64,64,2]: 14 MB of grid and output, a bound of 0.0043 ms) the
// one-thread-per-pixel version took 0.020 ms of device time on an H100:
// bound by instruction issue and load latency (64-bit divisions, 12
// dependent 2-byte gathers from L2 and three 2-byte stores at a 6-byte
// stride per pixel), not by bytes.  The TPU kernel keeps the small source
// resident in fast memory, and so does this one: persistent blocks each
// stage one source into shared memory, channels padded to CP = 4 or 8
// (C = 3 fixed at compile time), so a corner is one 8- to 32-byte shared
// load; then walk tiles of that source's grid pixels.  A thread takes
// kNarrowPPT pixels, their (x, y) loaded one tile ahead, with 32-bit index
// math and no division; the tile's output, one contiguous byte range of
// the NHWC output, is assembled in shared memory and written with 16-byte
// coalesced stores.  It takes 0.0125 ms (chip_smoke.py phase 6), still
// bound by issue, not bytes: in trial builds that left out one phase at a
// time, staging the source took about a quarter of the launch and the
// gathers and the output stores little; the rest is each pixel's
// coordinate and weight arithmetic.
//
// warp_wide.  At the generator's shapes (bf16 [1,64,64,256] by
// [32,64,64,2]: 67 MB of output, a bound of 0.0208 ms) the
// one-thread-per-(pixel, 8 channels) version took 0.047-0.052 ms: all 32
// threads of a pixel redid its coordinate math and 64-bit divisions, and
// its four 16-byte corner gathers went to L2 (4x the bytes it writes).
// Here a block owns an 8x8 tile of one grid's output pixels and all C
// channels: 64 threads compute the corner offsets and weights once per
// pixel into shared memory, then the block streams over (pixel, 16-byte
// channel vector) pairs, neighbours on neighbouring addresses: four
// read-only gathers (ld.global.nc, so the tile's corner reuse under a
// smooth warp is served by L1), the FMAs, and one 16-byte evict-first
// store (st.global.cs), so the output does not push the source out of L2.
// The batch index comes from blockIdx.  It takes 0.031 ms, 1.4x a
// store-only kernel writing the same 67 MB (0.022 ms): bound by its output
// bytes, plus the gathers.  Unrolling the pair loop, 16x16 tiles, 512
// threads and plain stores each measured slower in trial builds.
//
// warp_wide_b16 (K6).  twolevel_b16 is warp_wide's function with one more
// rounding: the y pass (each column's two row taps, summed in float32) is
// rounded to bfloat16 whatever the image type, then the x pass weights
// those rows in float32 and rounds once to the image type.  Its tents are
// max(0, 1 - |f - i|) at each tap's own integer i, the y tents cast to the
// image type before they multiply it.  The TPU kernel forms those sums as
// dense tent-matrix products; only two rows and two columns have non-zero
// tents, so here they are the same four-corner gather as warp_wide, in
// the same block and thread mapping, each output element
//   round_out(fl(tx0 * r0) + fl(tx1 * r1)),
//   rK = bf16(fl(ty0' * s(y0, xK)) + fl(ty1' * s(y1, xK))),
// with __fmul_rn / __fadd_rn so that nvcc contracts nothing into an FMA
// and each product and sum rounds as in the TPU kernel; bitwise its plain
// version.  Bound by its output bytes, as warp_wide is (bf16 [1,64,64,256]
// by [128,64,64,2]: 272.6 MB, 0.0814 ms at 3.35 TB/s), with about twice
// warp_wide's floating-point work.  Its first design, warp_wide's loop
// with each column's two loads, products and rounding one after the
// other, took 0.1687 ms on an H100 (700 W) against warp_wide's 0.1211 on
// the same inputs; in trial builds (chip_trials.py k6-parent) leaving the
// rounding out gave 0.1521, the four loads hoisted 0.1564 (48 registers
// to 40), the roundings paired 0.1620, all of that with a row's second
// product fused 0.1462; 40 registers or the loop unrolled twice, no
// faster.  So the loads' wait and the instruction count, not the
// roundings alone.  Here:
//   - the four corner loads first, then two channels at a time;
//   - a bfloat16 image's row value is one FMA over its first product (a
//     bfloat16 tent times a bfloat16 value is exact in float32), a
//     float32 image's two products and a sum as written;
//   - two row values rounded by one cvt.rn.bf16x2.f32, widened by shifts;
//   - a thread keeps one channel vector where the vectors divide the
//     block (C = 256), so a step costs no division (a division a step:
//     7-13% slower);
//   - its own kernel, warp_wide_b16_kernel, sharing warp_wide's tile
//     (wide_tile) with its registers capped at 32, eight blocks an SM
//     (uncapped, 48 registers, within 1% either way; the cap on the
//     shared template gave warp_wide 40 registers and cost it 8%).
// It takes 1.09-1.15x warp_wide's time on the same inputs (0.135-0.140
// against 0.121-0.124 ms, three trial runs in turns), 58-60% of its
// bound: six more instructions a value than warp_wide's 8.5 (the second
// products, the rounding and widening, the x pass's products and sum).
// Reading the corners through L2 only, the offsets or the weights as one
// 16-byte vector, or two pixels a step moved it by 1-4% either way.
//
// warp_groups (C not a multiple of 8, e.g. 35): pixel rows are not 16-byte
// aligned, so a thread owns up to 8 channels of one pixel and reads and
// writes them one by one; neighbouring threads cover neighbouring
// addresses.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace {

// The _rn intrinsics keep nvcc from contracting these into an FMA, so the
// pixel coordinate rounds exactly as in the plain version.
__device__ __forceinline__ float unnormalize(float g, int size, int align) {
  const float g1 = __fadd_rn(g, 1.f);
  return align ? __fmul_rn(__fmul_rn(g1, 0.5f), (float)(size - 1))
               : __fmul_rn(__fsub_rn(__fmul_rn(g1, (float)size), 1.f), 0.5f);
}

// Corner pixel indices (y*W+x, or -1 outside the image) and weights, in
// the order the plain version sums them: (x0,y0) (x1,y0) (x0,y1) (x1,y1).
__device__ __forceinline__ void corners(float gx, float gy, int H, int W,
                                        int align, int idx[4], float wgt[4]) {
  const float x = unnormalize(gx, W, align);
  const float y = unnormalize(gy, H, align);
  const float x0 = floorf(x), y0 = floorf(y);
  const float wx1 = x - x0, wy1 = y - y0;
  const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
  const float cx[4] = {x0, x0 + 1.f, x0, x0 + 1.f};
  const float cy[4] = {y0, y0, y0 + 1.f, y0 + 1.f};
  const float cw[4] = {wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const bool valid = cx[c] >= 0.f && cx[c] <= (float)(W - 1) &&
                       cy[c] >= 0.f && cy[c] <= (float)(H - 1);
    idx[c] = valid ? (int)cy[c] * W + (int)cx[c] : -1;
    wgt[c] = valid ? cw[c] : 0.f;
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One tent weight, max(0, 1 - |f - i|), rounded as twolevel_b16 rounds it.
__device__ __forceinline__ float tent(float f, float i) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(f, i))));
}

// K6's taps: corner offsets y*W+x (or -1 outside the image) in corners()'s
// order and weights {tx0, tx1, ty0', ty1'}, the y tents rounded to T.
template <typename T>
__device__ __forceinline__ void tents(float gx, float gy, int H, int W,
                                      int idx[4], float wgt[4]) {
  const float x = unnormalize(gx, W, 0);
  const float y = unnormalize(gy, H, 0);
  const float x0 = floorf(x), y0 = floorf(y);
  const float cx[2] = {x0, x0 + 1.f}, cy[2] = {y0, y0 + 1.f};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float xc = cx[c & 1], yc = cy[c >> 1];
    const bool valid = xc >= 0.f && xc <= (float)(W - 1) &&
                       yc >= 0.f && yc <= (float)(H - 1);
    idx[c] = valid ? (int)yc * W + (int)xc : -1;
  }
  wgt[0] = tent(x, cx[0]);
  wgt[1] = tent(x, cx[1]);
  wgt[2] = to_float(from_float<T>(tent(y, cy[0])));
  wgt[3] = to_float(from_float<T>(tent(y, cy[1])));
}

// Channels j and j + 1 of a 16-byte vector of T, as floats.
__device__ __forceinline__ float2 pair(const uint4& raw, int j,
                                       __nv_bfloat16) {
  const unsigned w = (&raw.x)[j >> 1];
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 pair(const uint4& raw, int j, float) {
  return make_float2(__uint_as_float((&raw.x)[j]),
                     __uint_as_float((&raw.x)[j + 1]));
}

// K6's row value before its rounding, fl(ty0 * s0) + fl(ty1 * s1) rounded
// once more.  For a bfloat16 image each product of a bfloat16 tent and a
// bfloat16 value is exact in float32 (8-bit significands; a product in
// float32's normal range), so the rounded sum is one FMA over the first
// product.
template <typename T>
__device__ __forceinline__ float row_sum(float ty0, float s0, float ty1,
                                         float s1) {
  if constexpr (sizeof(T) == 2)
    return fmaf(ty1, s1, __fmul_rn(ty0, s0));
  else
    return __fadd_rn(__fmul_rn(ty0, s0), __fmul_rn(ty1, s1));
}

// Two row values rounded to bfloat16 by one cvt.rn.bf16x2.f32 and
// widened back by shifts.
__device__ __forceinline__ float2 round_pair(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const unsigned w = *reinterpret_cast<const unsigned*>(&h);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// One pixel's (x, y) in one 8-byte (float32) or 4-byte (bfloat16) load.
__device__ __forceinline__ float2 load_xy(const float* g) {
  return __ldg(reinterpret_cast<const float2*>(g));
}
__device__ __forceinline__ float2 load_xy(const __nv_bfloat16* g) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(g)));
}

__device__ __forceinline__ void unpack(const uint4& raw, float v[8],
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& raw, float v[4], float) {
  const float4 f = *reinterpret_cast<const float4*>(&raw);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ uint4 pack(const float v[8], __nv_bfloat16) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return raw;
}
__device__ __forceinline__ uint4 pack(const float v[4], float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

// CP channels of a padded shared-memory pixel: 8 or 16 bytes (bf16), 16 or
// 32 bytes (f32).
template <int CP>
__device__ __forceinline__ void load_px(const __nv_bfloat16* p, float v[CP]) {
  if constexpr (CP == 8) {
    unpack(*reinterpret_cast<const uint4*>(p), v, __nv_bfloat16());
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
}
template <int CP>
__device__ __forceinline__ void load_px(const float* p, float v[CP]) {
#pragma unroll
  for (int i = 0; i < CP / 4; ++i)
    unpack(reinterpret_cast<const uint4*>(p)[i], v + 4 * i, float());
}


// K6's 16-byte vector of output channels c0.. of one pixel, from its
// corners' offsets and {tx0, tx1, ty0', ty1'} (a 16-byte row of shared
// memory): the four corners' loads first (a corner outside the image
// reads as zeros, whose product with a tent, >= 0, is +0), then two
// channels at a time, each column's row value rounded to bfloat16 as a
// pair, weighted by its x tent, the two columns summed and rounded to T.
template <typename T>
__device__ __forceinline__ void b16_vector(const T* __restrict__ s,
                                           T* __restrict__ o,
                                           const int (&taps)[4],
                                           const float (&weights)[4],
                                           int out_off, int c0) {
  constexpr int VEC = 16 / sizeof(T);
  const int4 offs = make_int4(taps[0], taps[1], taps[2], taps[3]);
  const float4 w = *reinterpret_cast<const float4*>(weights);
  uint4 raw[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int off = (&offs.x)[c];
    raw[c] = off >= 0 ? __ldg(reinterpret_cast<const uint4*>(s + off + c0))
                      : make_uint4(0u, 0u, 0u, 0u);
  }
  const float tx0 = w.x, tx1 = w.y, ty0 = w.z, ty1 = w.w;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; j += 2) {
    float2 v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = pair(raw[c], j, T());
    const float2 r0 = round_pair(row_sum<T>(ty0, v[0].x, ty1, v[2].x),
                                 row_sum<T>(ty0, v[0].y, ty1, v[2].y));
    const float2 r1 = round_pair(row_sum<T>(ty0, v[1].x, ty1, v[3].x),
                                 row_sum<T>(ty0, v[1].y, ty1, v[3].y));
    acc[j] = __fadd_rn(__fmul_rn(tx0, r0.x), __fmul_rn(tx1, r1.x));
    acc[j + 1] = __fadd_rn(__fmul_rn(tx0, r0.y), __fmul_rn(tx1, r1.y));
  }
  __stcs(reinterpret_cast<uint4*>(o + out_off + c0), pack(acc, T()));
}

constexpr int kWideTile = 8;            // 8x8 output pixels per block
constexpr int kWidePix = kWideTile * kWideTile;
constexpr int kWideThreads = 256;
constexpr int kNarrowThreads = 512;
constexpr int kNarrowPPT = 4;           // pixels per thread per tile
constexpr int kNarrowTile = kNarrowThreads * kNarrowPPT;
constexpr int kGroupThreads = 256;
constexpr int kMaxSmem = 232448;        // a block's opt-in maximum on sm_90

// One block per 8x8 tile of one grid's output, all C channels; C % 8 == 0.
// grid: x over tiles (row-major over ceil(Ho/8) x ceil(Wo/8)), y over B.
// B16: K6's two passes (tents(), the rows rounded to bfloat16), else the
// bilinear sample of corners().
template <typename T, typename G, bool B16>
__device__ __forceinline__ void
wide_tile(const T* __restrict__ src, const G* __restrict__ grid,
          T* __restrict__ out, int Ho, int Wo, int group, int H, int W, int C,
          int align) {
  constexpr int VEC = 16 / sizeof(T);   // channels per 16-byte vector
  __shared__ int s_src[kWidePix][4];    // corner offsets idx*C, or -1
  __shared__ __align__(16) float s_wgt[kWidePix][4];  // K6: 16-byte rows
  __shared__ int s_out[kWidePix];       // output offset p*C in the grid
  const int tiles_x = (Wo + kWideTile - 1) / kWideTile;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int y0 = ty * kWideTile, x0 = tx * kWideTile;
  const int tw = min(kWideTile, Wo - x0), th = min(kWideTile, Ho - y0);
  const int n_px = tw * th;
  const int b = blockIdx.y;
  const size_t P = (size_t)Ho * Wo;
  const int t = threadIdx.x;
  if (t < n_px) {
    const int ly = t / tw, lx = t - ly * tw;
    const int p = (y0 + ly) * Wo + x0 + lx;
    const float2 g = load_xy(grid + ((size_t)b * P + p) * 2);
    int idx[4];
    float wgt[4];
    if constexpr (B16)
      tents<T>(g.x, g.y, H, W, idx, wgt);
    else
      corners(g.x, g.y, H, W, align, idx, wgt);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s_src[t][c] = idx[c] < 0 ? -1 : idx[c] * C;
      s_wgt[t][c] = wgt[c];
    }
    s_out[t] = p * C;
  }
  __syncthreads();
  const T* s = src + (size_t)(b / group) * H * W * C;
  T* o = out + (size_t)b * P * C;
  const int vecs = C / VEC;
  const int pairs = n_px * vecs;
  if constexpr (B16) {
    // a thread keeps one channel vector where the vectors divide the
    // block's threads (C = 256: 32 vectors, 8 pixels at a time)
    if (kWideThreads % vecs == 0) {
      const int c0 = (t % vecs) * VEC;
#pragma unroll 1
      for (int q = t / vecs; q < n_px; q += kWideThreads / vecs)
        b16_vector(s, o, s_src[q], s_wgt[q], s_out[q], c0);
      return;
    }
#pragma unroll 1
    for (int k = t; k < pairs; k += kWideThreads) {
      const int q = k / vecs;
      b16_vector(s, o, s_src[q], s_wgt[q], s_out[q], (k - q * vecs) * VEC);
    }
    return;
  }
#pragma unroll 1
  for (int k = t; k < pairs; k += kWideThreads) {
    const int q = k / vecs;
    const int c0 = (k - q * vecs) * VEC;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int off = s_src[q][c];
      if (off < 0) continue;
      float val[VEC];
      unpack(__ldg(reinterpret_cast<const uint4*>(s + off + c0)), val, T());
      const float w = s_wgt[q][c];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(val[j], w, acc[j]);
    }
    __stcs(reinterpret_cast<uint4*>(o + s_out[q] + c0), pack(acc, T()));
  }
}

template <typename T, typename G>
__global__ void __launch_bounds__(kWideThreads)
warp_wide_kernel(const T* __restrict__ src, const G* __restrict__ grid,
                 T* __restrict__ out, int Ho, int Wo, int group, int H, int W,
                 int C, int align) {
  wide_tile<T, G, false>(src, grid, out, Ho, Wo, group, H, W, C, align);
}

// K6, its registers capped at 32 for eight blocks an SM.
template <typename T, typename G>
__global__ void __launch_bounds__(kWideThreads, 8)
warp_wide_b16_kernel(const T* __restrict__ src, const G* __restrict__ grid,
                     T* __restrict__ out, int Ho, int Wo, int group, int H,
                     int W, int C) {
  wide_tile<T, G, true>(src, grid, out, Ho, Wo, group, H, W, C, 0);
}

// Shared memory of warp_narrow_kernel: the padded source, then the output
// tile with 16 bytes of slack for its alignment.
template <typename T>
size_t narrow_smem(int H, int W, int C, int CP) {
  const size_t source = ((size_t)H * W * CP * sizeof(T) + 15) / 16 * 16;
  return source + (size_t)kNarrowTile * C * sizeof(T) + 16;
}

// Persistent blocks; block (x, s) stages source s into shared memory and
// walks tiles x, x + gridDim.x, ... of the group * P pixels of the grids
// that read it.  C <= CP channels, fixed at compile time when CC > 0.
template <typename T, typename G, int CP, int CC>
__global__ void __launch_bounds__(kNarrowThreads)
warp_narrow_kernel(const T* __restrict__ src, const G* __restrict__ grid,
                   T* __restrict__ out, int n_px, int H, int W, int C_arg,
                   int align) {
  constexpr int VE = 16 / sizeof(T);    // elements per 16-byte vector
  const int C = CC > 0 ? CC : C_arg;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_src = reinterpret_cast<T*>(smem);
  const int HW = H * W;
  T* s_tile = reinterpret_cast<T*>(
      smem + ((size_t)HW * CP * sizeof(T) + 15) / 16 * 16);
  const int s = blockIdx.y;
  const G* grid_s = grid + (size_t)s * n_px * 2;
  const int tiles = (n_px + kNarrowTile - 1) / kNarrowTile;
  // this thread's (x, y) of a tile: loaded one tile ahead, so that their
  // latency passes while the source is staged or the last tile written
  float2 g[kNarrowPPT];
  auto load_grid = [&](int t) {
#pragma unroll
    for (int i = 0; i < kNarrowPPT; ++i) {
      const int p = t * kNarrowTile + threadIdx.x + i * kNarrowThreads;
      if (t < tiles && p < n_px) g[i] = load_xy(grid_s + 2 * p);
    }
  };
  load_grid(blockIdx.x);

  // stage the source a pixel per thread, channels padded to CP with zeros
  const T* src_s = src + (size_t)s * HW * C;
#pragma unroll 4
  for (int p = threadIdx.x; p < HW; p += kNarrowThreads) {
#pragma unroll
    for (int c = 0; c < CP; ++c)
      s_src[p * CP + c] = c < C ? __ldg(src_s + p * C + c) : from_float<T>(0.f);
  }
  __syncthreads();

  const long long e_src = (long long)s * n_px * C;   // first output element
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int p0 = t * kNarrowTile;
    const int np = min(kNarrowTile, n_px - p0);
    const long long e0 = e_src + (long long)p0 * C;
    // the tile sits in shared memory at the same offset mod 16 bytes as in
    // the output, so its aligned middle moves as 16-byte vectors
    const int lead = (int)(e0 % VE);
    T* tile = s_tile + lead;
#pragma unroll
    for (int i = 0; i < kNarrowPPT; ++i) {
      const int q = threadIdx.x + i * kNarrowThreads;
      if (q >= np) continue;
      int idx[4];
      float wgt[4];
      corners(g[i].x, g[i].y, H, W, align, idx, wgt);
      float acc[CP];
#pragma unroll
      for (int j = 0; j < CP; ++j) acc[j] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (idx[c] < 0) continue;
        float val[CP];
        load_px<CP>(s_src + idx[c] * CP, val);
#pragma unroll
        for (int j = 0; j < CP; ++j)
          if (j < C) acc[j] = fmaf(val[j], wgt[c], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < CP; ++j)
        if (j < C) tile[q * C + j] = from_float<T>(acc[j]);
    }
    load_grid(t + gridDim.x);
    __syncthreads();
    const int n = np * C;
    const int head = min((VE - lead) % VE, n);
    const int n_vec_out = (n - head) / VE;
    T* o = out + e0;
    for (int k = threadIdx.x; k < head; k += kNarrowThreads) o[k] = tile[k];
    const uint4* tv = reinterpret_cast<const uint4*>(tile + head);
    uint4* ov = reinterpret_cast<uint4*>(o + head);
    for (int k = threadIdx.x; k < n_vec_out; k += kNarrowThreads) ov[k] = tv[k];
    for (int k = head + n_vec_out * VE + threadIdx.x; k < n;
         k += kNarrowThreads)
      o[k] = tile[k];
    __syncthreads();                    // the tile buffer is reused
  }
}

// One thread per (output pixel, group of up to 8 channels); any C.
template <typename T, typename G>
__global__ void warp_groups_kernel(const T* __restrict__ src,
                                   const G* __restrict__ grid,
                                   T* __restrict__ out, long long n_pix,
                                   int P, int group, int H, int W, int C,
                                   int align) {
  const int groups = (C + 7) / 8;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_pix * groups) return;
  const long long pix = t / groups;
  const int c0 = (int)(t - pix * groups) * 8;
  const int n = min(8, C - c0);
  const int b = (int)(pix / P);
  int idx[4];
  float wgt[4];
  const float2 g = load_xy(grid + 2 * pix);
  corners(g.x, g.y, H, W, align, idx, wgt);
  const T* s = src + (long long)(b / group) * H * W * C + c0;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (idx[c] < 0) continue;
    const T* corner = s + (long long)idx[c] * C;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) acc[j] = fmaf(to_float(corner[j]), wgt[c], acc[j]);
  }
  T* o = out + pix * C + c0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < n) o[j] = from_float<T>(acc[j]);
}

__global__ void store_only_kernel(uint4* __restrict__ out, long long n_vec) {
  const long long i = (long long)blockIdx.x * blockDim.x * 4 + threadIdx.x;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i + j * blockDim.x < n_vec) out[i + j * blockDim.x] = make_uint4(0, 0, 0, 0);
}

struct Args {
  const void* src;
  const void* grid;
  void* out;
  int B, Ho, Wo, group, H, W, C, align;
  cudaStream_t stream;
};

template <typename T, typename G, bool B16 = false>
cudaError_t launch_wide(const Args& a) {
  const int tiles = ((a.Ho + kWideTile - 1) / kWideTile) *
                    ((a.Wo + kWideTile - 1) / kWideTile);
  if constexpr (B16)
    warp_wide_b16_kernel<T, G><<<dim3(tiles, a.B), kWideThreads, 0,
                                 a.stream>>>(
        static_cast<const T*>(a.src), static_cast<const G*>(a.grid),
        static_cast<T*>(a.out), a.Ho, a.Wo, a.group, a.H, a.W, a.C);
  else
    warp_wide_kernel<T, G><<<dim3(tiles, a.B), kWideThreads, 0, a.stream>>>(
        static_cast<const T*>(a.src), static_cast<const G*>(a.grid),
        static_cast<T*>(a.out), a.Ho, a.Wo, a.group, a.H, a.W, a.C, a.align);
  return cudaGetLastError();
}

template <typename T, typename G, int CP, int CC>
cudaError_t launch_narrow_cp(const Args& a) {
  auto kernel = warp_narrow_kernel<T, G, CP, CC>;
  const int smem = (int)narrow_smem<T>(a.H, a.W, a.C, CP);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // the card's resident blocks for this shared-memory size, queried once
  // per device and size, so that a launch (or a CUDA graph capture of it)
  // makes no other runtime call
  static int cached_device = -1, cached_smem = -1, resident = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != cached_device || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kMaxSmem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kNarrowThreads, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_device = device;
    cached_smem = smem;
    resident = sms * per_sm;
  }
  const int n_px = a.group * a.Ho * a.Wo;
  const int Bi = a.B / a.group;
  const int tiles = (n_px + kNarrowTile - 1) / kNarrowTile;
  // as many blocks as the card holds at once, split over the sources, and
  // no more than each source's tiles, balanced so that every block walks
  // the same number of tiles
  const int most = max(1, resident / Bi);
  const int rounds = (tiles + most - 1) / most;
  const int blocks = (tiles + rounds - 1) / rounds;
  kernel<<<dim3(blocks, Bi), kNarrowThreads, smem, a.stream>>>(
      static_cast<const T*>(a.src), static_cast<const G*>(a.grid),
      static_cast<T*>(a.out), n_px, a.H, a.W, a.C, a.align);
  return cudaGetLastError();
}

template <typename T, typename G>
cudaError_t launch_narrow(const Args& a) {
  if (a.C == 3) return launch_narrow_cp<T, G, 4, 3>(a);   // RGB
  return a.C <= 4 ? launch_narrow_cp<T, G, 4, 0>(a)
                  : launch_narrow_cp<T, G, 8, 0>(a);
}

template <typename T, typename G>
cudaError_t launch_groups(const Args& a) {
  const long long n_pix = (long long)a.B * a.Ho * a.Wo;
  const long long n_threads = n_pix * ((a.C + 7) / 8);
  const unsigned blocks =
      (unsigned)((n_threads + kGroupThreads - 1) / kGroupThreads);
  warp_groups_kernel<T, G><<<blocks, kGroupThreads, 0, a.stream>>>(
      static_cast<const T*>(a.src), static_cast<const G*>(a.grid),
      static_cast<T*>(a.out), n_pix, a.Ho * a.Wo, a.group, a.H, a.W, a.C,
      a.align);
  return cudaGetLastError();
}

// dtype (image, output) and gdtype (grid): 0 float32, 1 bfloat16.
template <template <typename, typename> class Launch>
int dispatch(int dtype, int gdtype, const Args& a) {
  if ((dtype != 0 && dtype != 1) || (gdtype != 0 && gdtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear any earlier error of this runtime
  if (dtype == 0)
    return (int)(gdtype == 0 ? Launch<float, float>::run(a)
                             : Launch<float, __nv_bfloat16>::run(a));
  return (int)(gdtype == 0 ? Launch<__nv_bfloat16, float>::run(a)
                           : Launch<__nv_bfloat16, __nv_bfloat16>::run(a));
}

template <typename T, typename G>
struct Wide { static cudaError_t run(const Args& a) { return launch_wide<T, G>(a); } };
template <typename T, typename G>
struct WideB16 { static cudaError_t run(const Args& a) { return launch_wide<T, G, true>(a); } };
template <typename T, typename G>
struct Narrow { static cudaError_t run(const Args& a) { return launch_narrow<T, G>(a); } };
template <typename T, typename G>
struct Groups { static cudaError_t run(const Args& a) { return launch_groups<T, G>(a); } };

// 32-bit index math inside one source and one grid, and B in gridDim.y.
bool fits(int B, int Ho, int Wo, int group, int H, int W, int C) {
  return B >= 1 && B <= 65535 && group >= 1 && B % group == 0 &&
         (long long)H * W * C <= INT_MAX &&
         (long long)group * Ho * Wo * (C < 2 ? 2 : C) <= INT_MAX;
}

}  // namespace

// B grids of Ho x Wo pixels each over B / group images.  dtype (image,
// output) and gdtype (grid): 0 float32, 1 bfloat16.  Returns the launch's
// cudaError_t.
extern "C" int eamm_warp_wide(const void* src, const void* grid, void* out,
                              int dtype, int gdtype, int B, int Ho, int Wo,
                              int group, int H, int W, int C, int align,
                              void* stream) {
  if (C % 8 != 0 || !fits(B, Ho, Wo, group, H, W, C))
    return (int)cudaErrorInvalidValue;
  return dispatch<Wide>(dtype, gdtype,
                        {src, grid, out, B, Ho, Wo, group, H, W, C, align,
                         static_cast<cudaStream_t>(stream)});
}

// K6: warp_wide's warp with the y pass rounded to bfloat16, align_corners
// False (twolevel_b16 takes no other); C % 8 == 0.
extern "C" int eamm_warp_wide_b16(const void* src, const void* grid,
                                  void* out, int dtype, int gdtype, int B,
                                  int Ho, int Wo, int group, int H, int W,
                                  int C, void* stream) {
  if (C % 8 != 0 || !fits(B, Ho, Wo, group, H, W, C))
    return (int)cudaErrorInvalidValue;
  return dispatch<WideB16>(dtype, gdtype,
                           {src, grid, out, B, Ho, Wo, group, H, W, C, 0,
                            static_cast<cudaStream_t>(stream)});
}

// 1 <= C <= 8; the padded source and an output tile must fit in one
// block's shared memory (eamm_tpu_torch.ops.warp_cuda.narrow_smem_bytes).
extern "C" int eamm_warp_narrow(const void* src, const void* grid, void* out,
                                int dtype, int gdtype, int B, int Ho, int Wo,
                                int group, int H, int W, int C, int align,
                                void* stream) {
  if (C < 1 || C > 8 || !fits(B, Ho, Wo, group, H, W, C))
    return (int)cudaErrorInvalidValue;
  return dispatch<Narrow>(dtype, gdtype,
                          {src, grid, out, B, Ho, Wo, group, H, W, C, align,
                           static_cast<cudaStream_t>(stream)});
}

// Any C >= 1: warp_wide's kernel when C % 8 == 0, else groups of up to 8
// channels read and written one by one.
extern "C" int eamm_warp_shared(const void* src, const void* grid, void* out,
                                int dtype, int gdtype, int B, int Ho, int Wo,
                                int group, int H, int W, int C, int align,
                                void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  const Args a{src, grid, out, B, Ho, Wo, group, H, W, C, align,
               static_cast<cudaStream_t>(stream)};
  if (C % 8 == 0) {
    if (!fits(B, Ho, Wo, group, H, W, C)) return (int)cudaErrorInvalidValue;
    return dispatch<Wide>(dtype, gdtype, a);
  }
  return dispatch<Groups>(dtype, gdtype, a);
}

// Zeros over n_bytes (a multiple of 16) with 16-byte stores and nothing
// else: the card's write ceiling for a kernel that writes that many bytes.
// A yardstick for the warps' timings; no model calls it.
extern "C" int eamm_store_only(void* out, long long n_bytes, void* stream) {
  if (n_bytes <= 0 || n_bytes % 16) return (int)cudaErrorInvalidValue;
  cudaGetLastError();
  const long long n_vec = n_bytes / 16;
  const long long blocks = (n_vec + 256 * 4 - 1) / (256 * 4);
  store_only_kernel<<<(unsigned)blocks, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(out), n_vec);
  return (int)cudaGetLastError();
}

extern "C" const char* eamm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
