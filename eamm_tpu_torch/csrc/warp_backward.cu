// Backward of the bilinear warps (zeros padding) for NVIDIA Hopper.
//
// The TPU package trains through XLA's autodiff of eamm_tpu/ops/warp.py
// (grid_sample): its warp kernels K1 (warp_pallas.py
// grid_sample_twolevel_pallas) and K2 (grid_sample_smallc_pallas) have no
// backward of their own.  The port calls its forward kernels warp_wide and
// warp_narrow (csrc/warp.cu) on every route, training included, so their
// gradients are these kernels:
//   warp_wide_backward   (K1b) <- the autodiff of the bottleneck warp,
//                                  [Bi,64,64,256] by [B,64,64,2];
//   warp_narrow_backward (K2b) <- the autodiff of dense motion's K+1
//                                  deformed copies, [Bi,64,64,3] by
//                                  [Bi*11,64,64,2].
// Given grad_out [B,Ho,Wo,C]:
//   grad_image [Bi,H,W,C]: each output pixel adds its four corner weights
//     times grad_out into source b / (B / Bi);
//   grad_grid [B,Ho,Wo,2]: sum over c of grad_out_c times the corner
//     values weighted by d(weight)/dx and d(weight)/dy, times the
//     unnormalize factor (W/2, H/2; (W-1)/2, (H-1)/2 with align_corners).
// A corner outside the image contributes to neither, and floor() is flat:
// what autodiff of the plain version (ops/warp.py grid_sample) gives.
// Sums are float32, rounded once to the image type for grad_image, which
// each kernel writes once with no accumulator; grad_grid is written in
// the grid's type.
//
// What bounds them: the bytes.  Each input read once and each gradient
// written once is 303.6 MB for K1b at the fine-tune step's shape (f32
// [24,64,64,256] by [24,64,64,2]), 0.0906 ms at 3.35 TB/s; its arithmetic
// is ~8 operations per (pixel, corner, channel), far below the card's rate.
//
// K1b, redesigned: the image gradient is GATHERED, not scattered.  The
// first design (one block per 8x8 output tile, one float32 global atomic
// per pixel, corner and channel into a zeroed float32 accumulator, the
// grid gradient reduced by shared-memory atomics on which all 32 lanes of
// a warp collided) took 0.5799 ms on an H100 (700 W), and split by what it
// was asked for: image only 0.4889, grid only 0.2494 with a random grid;
// 0.6224 / 0.2626 / 0.7301 with a near-identity grid, the training
// path's, whose neighbouring pixels' atomics hit the same addresses.  So
// the scatter dominated.  Hopper's vector reductions (atomicAdd on float4,
// REDG.E.ADD.F32x4) would cut the atomics 4x but keep the accumulator's
// memset and its read-modify-write in L2: 500 MB of DRAM at the least.
// The gather needs neither:
//   1. bins: each output pixel goes to the bin of the 8x8 source tile that
//      holds its base corner (floor x, floor y), with one more row and
//      column of bins for a base corner at -1; a counting sort (count with
//      an integer atomic per pixel, an exclusive scan, place) lists each
//      bin's pixels.  Grids of one source share its bins.
//   2. gather: one block per (source tile, 128-channel slice).  A pixel
//      with a corner in the tile has its base corner in the tile or in
//      the tiles to its left, above or above-left, so the block reads
//      those four bins, staged 256 pixels at a time in shared memory
//      (corner weights computed once).  Warp r owns row r of the tile:
//      it takes the staged pixels with a corner on that row (a ballot),
//      four at a time (their grad_out loads in flight together), a lane
//      per 4 channels; it adds weight x grad_out into its row's float32
//      sums in shared memory (no other warp writes them: no atomics) and
//      reduces the four pixels' corner dots dot(grad_out, image) over the
//      lanes together (eight sums in nine shuffles) into a [slice, pixel,
//      corner] buffer.  The block writes its tile's gradient once, in the
//      image type: no accumulator, no memset, no rounding pass.
//   3. grid gradient: a thread per output pixel adds its valid corners'
//      dots times the weights' derivatives.
// grad_out is read once plus once more for a pixel whose corners
// straddle a tile edge (~1/4 of them, from L2 when the neighbour ran just
// before), the image tile once, grad_image written once.  grad_grid is
// deterministic; grad_image's sums follow each bin's order, which the
// counting atomics leave to the scheduler, so its last bit may differ
// between runs.  A grid that sends most pixels to one tile serialises on
// that tile's block; the training path's grids spread.  On an H100 it
// takes 0.17 ms at the shape above (53% of its bound, 0.19 at the
// training path's grids); a warp waits on one batch of four loads at a
// time, and batches of eight or unrolled tile loads were slower.
//
// K2b, redesigned.  The training path asks it for the grid gradient
// alone, f32 [24,64,64,3] by [264,64,64,2] (group 11): 31.5 MB, 0.0094 ms
// at 3.35 TB/s.  The first design (a thread a pixel, eight pixels one
// after another; per pixel its (x, y), 12 scalar gathers of the source
// from L2 and 3 of grad_out; for grad_image a memset, a shared-memory
// float atomic per pixel, corner and channel, a global atomic per source
// value per block and a rounding pass) took 0.0252 ms on an H100 (700 W).
// Trial builds that left one part out (chip_trials.py k2b-parent): the
// grid's loads 0.0156, the gathers 0.0151, grad_out's loads 0.0249, the
// stores 0.0246, all four 0.0115.  So each pixel's chain of grid load,
// corners and gathers cost it, not its bytes.  Here:
//   - persistent blocks, each for one source, stage its bytes as they are
//     in shared memory with 16-byte loads, so a corner is 4 bytes a
//     channel from shared memory (a bulk copy, cp.async.bulk completed on
//     an mbarrier, measured 11% slower; C = 3 is read unpadded);
//   - a lane a pixel, neighbouring lanes on neighbouring pixels, four
//     pixels a thread a block apart, all their loads issued before any
//     arithmetic; 32-bit index math inside a source;
//   - grad_out read in place through its strides: dense motion's
//     gradient arrives a plane a channel (its concatenation is channel
//     first), and making it NHWC contiguous cost 0.0094 ms a call;
//   - the grid gradient's arithmetic per pixel is the first design's.
// The grid gradient alone takes 0.0136 ms (69% of its bound), 0.0126 at
// near-identity grids, 0.0146 at the fine-tune step's own arguments
// (aten's grid_sampler_2d_backward 0.0249).  Tried and slower
// (chip_trials.py k2b): a lane a run of 16 bytes of one channel's pixels
// with 16-byte loads and stores (11%: four-apart lanes share
// shared-memory banks; loading each run a tile ahead cost it 3-5% more),
// evict-first loads (14%), eight pixels a thread (6%), 512 threads (19%),
// registers capped for three or four blocks an SM (3%).
// The image gradient: each block adds its pixels' terms into float32 sums
// of the source in its shared memory (a float atomic there is a CAS loop
// on sm_90a), and the source's blocks, one thread block cluster of up to
// 8 (512 threads each, so that 8 still fill the card), add those sums in
// block order through distributed shared memory and write grad_image
// once in the image type: no memset, no global atomics, no rounding pass.
// Both gradients take 0.0515 ms (the first design 0.0674), the image
// gradient alone 0.0442 (0.0423): the CAS loops.  Clusters of up to 16
// (11 blocks a source, fewer clusters at once) were 45% slower, 256
// threads 56%.  grad_grid is deterministic; grad_image's sums within a
// block follow the atomics' order, so its last bit may differ between
// runs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 8;                // K1b's source tiles, a warp a row
constexpr int kGatherThreads = 32 * kTile;
constexpr int kSlice = 128;             // channels a block: 32 lanes x 4
constexpr int kChunk = kGatherThreads;  // bin entries staged at once
constexpr int kBinThreads = 256;
constexpr int kScanThreads = 1024;
// K2b's threads a block: with the image gradient 512, so that a cluster
// of at most 8 blocks a source still fills the card, else 256
template <bool IMG>
constexpr int kNarrowThreads = IMG ? 512 : 256;
constexpr int kMaxSmem = 232448;        // a block's opt-in maximum on sm_90

// The _rn intrinsics keep nvcc from contracting these into an FMA, so the
// pixel coordinate rounds as in the plain version.
__device__ __forceinline__ float unnormalize(float g, int size, int align) {
  const float g1 = __fadd_rn(g, 1.f);
  return align ? __fmul_rn(__fmul_rn(g1, 0.5f), (float)(size - 1))
               : __fmul_rn(__fsub_rn(__fmul_rn(g1, (float)size), 1.f), 0.5f);
}

// Corner pixel indices (y*W+x, or -1 outside the image), weights and the
// weights' derivatives in x and y, in the order (x0,y0) (x1,y0) (x0,y1)
// (x1,y1); a corner outside the image has weight and derivatives 0.
__device__ __forceinline__ void corners(float gx, float gy, int H, int W,
                                        int align, int idx[4], float wgt[4],
                                        float dwx[4], float dwy[4]) {
  const float x = unnormalize(gx, W, align);
  const float y = unnormalize(gy, H, align);
  const float x0 = floorf(x), y0 = floorf(y);
  const float wx1 = x - x0, wy1 = y - y0;
  const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
  const float cx[4] = {x0, x0 + 1.f, x0, x0 + 1.f};
  const float cy[4] = {y0, y0, y0 + 1.f, y0 + 1.f};
  const float cw[4] = {wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1};
  const float cdx[4] = {-wy0, wy0, -wy1, wy1};
  const float cdy[4] = {-wx0, -wx1, wx0, wx1};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const bool valid = cx[c] >= 0.f && cx[c] <= (float)(W - 1) &&
                       cy[c] >= 0.f && cy[c] <= (float)(H - 1);
    idx[c] = valid ? (int)cy[c] * W + (int)cx[c] : -1;
    wgt[c] = valid ? cw[c] : 0.f;
    dwx[c] = valid ? cdx[c] : 0.f;
    dwy[c] = valid ? cdy[c] : 0.f;
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The unnormalize factor: d(pixel coordinate) / d(grid coordinate).
__device__ __forceinline__ float scale_of(int size, int align) {
  return align ? 0.5f * (float)(size - 1) : 0.5f * (float)size;
}

// ---------------------------------------------------------------- K1b

// Four channels of T as floats, and back.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Sums over a warp's lanes of eight values at once: each step halves the
// values a lane keeps, trading the other half with its partner, so lane l
// ends with the sum of v[(l >> 2) & 7].
__device__ __forceinline__ float reduce8(const float (&v)[8], int lane) {
  float a[4], b[2];
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    a[j] = (hi16 ? v[j + 4] : v[j]) +
           __shfl_xor_sync(0xffffffffu, hi16 ? v[j] : v[j + 4], 16);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    b[j] = (hi8 ? a[j + 2] : a[j]) +
           __shfl_xor_sync(0xffffffffu, hi8 ? a[j] : a[j + 2], 8);
  float c = (hi4 ? b[1] : b[0]) +
            __shfl_xor_sync(0xffffffffu, hi4 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(0xffffffffu, c, 2);
  c += __shfl_xor_sync(0xffffffffu, c, 1);
  return c;
}

// A grid point's base corner (x0, y0) = floor of its pixel coordinates and
// the fractions past it; `in` when some corner lies inside the image
// (x0 in [-1, W-1] and y0 in [-1, H-1]), as corners() finds them.
struct Base {
  int x0, y0;
  float fx, fy;
  bool in;
};

template <typename G>
__device__ __forceinline__ Base base_of(const G* g2, int H, int W, int align) {
  const float x = unnormalize(to_float(g2[0]), W, align);
  const float y = unnormalize(to_float(g2[1]), H, align);
  const float x0 = floorf(x), y0 = floorf(y);
  Base b;
  b.in = x0 >= -1.f && x0 <= (float)(W - 1) && y0 >= -1.f &&
         y0 <= (float)(H - 1);
  b.x0 = b.in ? (int)x0 : 0;
  b.y0 = b.in ? (int)y0 : 0;
  b.fx = x - x0;
  b.fy = y - y0;
  return b;
}

// The bin of a base corner within its source: tiles of kTile, shifted by
// one so that a base corner at -1 has a bin of its own.
__device__ __forceinline__ int bin_of(const Base& b, int bins_x) {
  return (b.y0 + kTile) / kTile * bins_x + (b.x0 + kTile) / kTile;
}

// Bins, step 1: each output pixel o's bin (source-major) and its rank
// among the bin's pixels, or -1 where no corner lies inside the image.
template <typename G>
__global__ void __launch_bounds__(kBinThreads)
bin_count_kernel(const G* __restrict__ grid, int* __restrict__ counts,
                 int2* __restrict__ slot, long long BP, int P, int group,
                 int H, int W, int align, int bins_x, int bins) {
  for (long long o = (long long)blockIdx.x * kBinThreads + threadIdx.x;
       o < BP; o += (long long)gridDim.x * kBinThreads) {
    const Base b = base_of(grid + 2 * o, H, W, align);
    int key = -1, rank = 0;
    if (b.in) {
      key = (int)(o / P / group) * bins + bin_of(b, bins_x);
      rank = atomicAdd(counts + key, 1);
    }
    slot[o] = make_int2(key, rank);
  }
}

// Bins, step 2, one block: offsets[i] = counts[0] + ... + counts[i - 1]
// for i <= n.
__global__ void __launch_bounds__(kScanThreads)
bin_scan_kernel(const int* __restrict__ counts, int* __restrict__ offsets,
                int n) {
  __shared__ int warp_total[kScanThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  for (int first = 0; first < n; first += kScanThreads) {
    const int i = first + threadIdx.x;
    const int v = i < n ? counts[i] : 0;
    int x = v;  // the warp's inclusive scan
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_total[wid] = x;
    __syncthreads();
    if (wid == 0) {
      int t = warp_total[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, t, d);
        if (lane >= d) t += y;
      }
      warp_total[lane] = t;
    }
    __syncthreads();
    const int before = carry + (wid > 0 ? warp_total[wid - 1] : 0) + x - v;
    if (i < n) offsets[i] = before;
    __syncthreads();  // every thread has read carry
    if (threadIdx.x == kScanThreads - 1) carry = before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) offsets[n] = carry;
}

// Bins, step 3: list[offsets[bin] + rank] = o.
__global__ void __launch_bounds__(kBinThreads)
bin_place_kernel(const int2* __restrict__ slot,
                 const int* __restrict__ offsets, int* __restrict__ list,
                 long long BP) {
  for (long long o = (long long)blockIdx.x * kBinThreads + threadIdx.x;
       o < BP; o += (long long)gridDim.x * kBinThreads) {
    const int2 s = slot[o];
    if (s.x >= 0) list[offsets[s.x] + s.y] = (int)o;
  }
}

// A staged output pixel: its index, its base corner less the tile's
// origin and its four corner weights in corners()' order; o < 0 when it
// has no corner in the tile.
struct Staged {
  int o, rx, ry;
  float w[4];
};

// K1b's gather: block (tile, source, slice); C % 8 == 0.  Dynamic shared
// memory: with gsrc, the tile's float32 sums [kTile * kTile][kSlice]; with
// dots, then the tile's image slice as floats, the same size.
template <typename T, typename G>
__global__ void __launch_bounds__(kGatherThreads)
warp_wide_backward_kernel(const T* __restrict__ src,
                          const G* __restrict__ grid,
                          const T* __restrict__ gout, T* __restrict__ gsrc,
                          float* __restrict__ dots,
                          const int* __restrict__ offsets,
                          const int* __restrict__ list, long long BP, int H,
                          int W, int C, int align, int tiles_x, int bins_x,
                          int bins) {
  extern __shared__ float4 smem4[];
  __shared__ Staged staged[kChunk];
  constexpr int kRow = kTile * 32;  // float4s of one tile row's sums
  float4* const acc = gsrc != nullptr ? smem4 : nullptr;
  float4* const img =
      dots != nullptr ? smem4 + (gsrc != nullptr ? kTile * kRow : 0) : nullptr;
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int oy = ty * kTile, ox = tx * kTile;
  const int th = min(kTile, H - oy), tw = min(kTile, W - ox);
  const int s = blockIdx.y, slice = blockIdx.z;
  const int ch = slice * kSlice + lane * 4;
  const bool on = ch < C;
  // row r's first pixel in the source, as an element offset
  const size_t row0 = (((size_t)s * H + oy + r) * W + ox) * C + ch;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < th) {
    for (int c = 0; c < tw; ++c) {
      if (acc != nullptr) acc[r * kRow + c * 32 + lane] = zero;
      if (img != nullptr)
        img[r * kRow + c * 32 + lane] =
            on ? load4(src + row0 + (size_t)c * C) : zero;
    }
  }
  // the bins of the tile and of the tiles left, above and above-left
  int lo[4], n[4], total = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key =
        s * bins + (ty + 1 - (j >> 1)) * bins_x + (tx + 1 - (j & 1));
    lo[j] = offsets[key];
    n[j] = offsets[key + 1] - lo[j];
    total += n[j];
  }
  for (int first = 0; first < total; first += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    {
      Staged st;
      st.o = -1;
      int i = first + threadIdx.x;
      if (i < total) {
        int j = 0;
        while (i >= n[j]) i -= n[j++];
        const int o = list[lo[j] + i];
        const Base b = base_of(grid + 2 * (size_t)o, H, W, align);
        const int rx = b.x0 - ox, ry = b.y0 - oy;
        // a column of x0, x0 + 1 and a row of y0, y0 + 1 in the tile
        if (rx >= -1 && rx < tw && ry >= -1 && ry < th) {
          const float wx0 = 1.f - b.fx, wy0 = 1.f - b.fy;
          st.o = o;
          st.rx = rx;
          st.ry = ry;
          st.w[0] = wx0 * wy0;
          st.w[1] = b.fx * wy0;
          st.w[2] = wx0 * b.fy;
          st.w[3] = b.fx * b.fy;
        }
      }
      staged[threadIdx.x] = st;
    }
    __syncthreads();
    const int count = min(kChunk, total - first);
    if (r >= th) continue;
    for (int k0 = 0; k0 < count; k0 += 32) {
      const int k = k0 + lane;
      const bool mine = k < count && staged[k].o >= 0 &&
                        (staged[k].ry == r || staged[k].ry == r - 1);
      unsigned mask = __ballot_sync(0xffffffffu, mine);
      while (mask != 0u) {
        int id[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          id[u] = mask != 0u ? k0 + __ffs(mask) - 1 : -1;
          mask &= mask - 1u;
        }
        float4 g[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          g[u] = id[u] >= 0 && on
                     ? load4(gout + (size_t)staged[id[u]].o * C + ch)
                     : zero;
        float d[8];  // lane partials of dot(grad_out, image), corner (u, dx)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          d[2 * u] = d[2 * u + 1] = 0.f;
          if (id[u] < 0) continue;
          const Staged& st = staged[id[u]];
          const int row = st.ry == r ? 0 : 2;  // corners 0, 1 on y0; 2, 3 on y0 + 1
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const int c = st.rx + dx;
            if (c < 0 || c >= tw) continue;
            const int at = r * kRow + c * 32 + lane;
            if (acc != nullptr) {
              const float w = st.w[row + dx];
              float4 a = acc[at];
              a.x = fmaf(w, g[u].x, a.x);
              a.y = fmaf(w, g[u].y, a.y);
              a.z = fmaf(w, g[u].z, a.z);
              a.w = fmaf(w, g[u].w, a.w);
              acc[at] = a;
            }
            if (img != nullptr) {
              const float4 v = img[at];
              float e = g[u].x * v.x;
              e = fmaf(g[u].y, v.y, e);
              e = fmaf(g[u].z, v.z, e);
              d[2 * u + dx] = fmaf(g[u].w, v.w, e);
            }
          }
        }
        if (img == nullptr) continue;
        // the eight sums over the lanes at once: lane l ends with the sum
        // of d[(l >> 2) & 7], in 4 + 2 + 1 + 2 shuffles
        const float sum = reduce8(d, lane);
        const int u = lane >> 3, dx = (lane >> 2) & 1;
        const int mine_id = u == 0 ? id[0] : u == 1 ? id[1] : u == 2 ? id[2] : id[3];
        if ((lane & 3) == 0 && mine_id >= 0) {
          const Staged& st = staged[mine_id];
          const int c = st.rx + dx;
          if (c >= 0 && c < tw)
            dots[((size_t)slice * BP + st.o) * 4 + (st.ry == r ? 0 : 2) +
                 dx] = sum;
        }
      }
    }
  }
  // warp r alone wrote row r's sums
  if (acc == nullptr || r >= th || !on) return;
  for (int c = 0; c < tw; ++c)
    store4(gsrc + row0 + (size_t)c * C, acc[r * kRow + c * 32 + lane]);
}

// K1b's grid gradient: a thread per output pixel, its valid corners' dots
// (summed over the slices) times the weights' derivatives.
template <typename G>
__global__ void __launch_bounds__(kBinThreads)
grid_grad_kernel(const G* __restrict__ grid, const float* __restrict__ dots,
                 G* __restrict__ ggrid, long long BP, int slices, int H,
                 int W, int align) {
  const float fx = scale_of(W, align), fy = scale_of(H, align);
  for (long long o = (long long)blockIdx.x * kBinThreads + threadIdx.x;
       o < BP; o += (long long)gridDim.x * kBinThreads) {
    const G* g2 = grid + 2 * o;
    int idx[4];
    float wgt[4], dwx[4], dwy[4];
    corners(to_float(g2[0]), to_float(g2[1]), H, W, align, idx, wgt, dwx, dwy);
    float ax = 0.f, ay = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (idx[c] < 0) continue;
      float d = 0.f;
      for (int sl = 0; sl < slices; ++sl)
        d += dots[((size_t)sl * BP + o) * 4 + c];
      ax = fmaf(d, dwx[c], ax);
      ay = fmaf(d, dwy[c], ay);
    }
    ggrid[2 * o] = from_float<G>(ax * fx);
    ggrid[2 * o + 1] = from_float<G>(ay * fy);
  }
}

// ---------------------------------------------------------------- K2b

// K2b's grad_out layout: element (b, pixel q, channel j) at b * image +
// q * pixel + j * channel, rows of pixels evenly strided: NHWC contiguous
// (dense), or as dense motion's gradient arrives, a plane a channel
// behind a heatmap's plane (image 4 * P, pixel 1, channel P).
struct NarrowOut {
  int dense;
  int P;                                // Ho * Wo
  long long image, pixel, channel;
};

// K2b's pixels a thread takes at once, a block's threads apart.
constexpr int kNarrowPixels = 4;

// One pixel's (x, y) in one 8-byte (float32) or 4-byte (bfloat16) load,
// and its grid gradient in one store.
__device__ __forceinline__ float2 load_xy(const float* g) {
  return __ldg(reinterpret_cast<const float2*>(g));
}
__device__ __forceinline__ float2 load_xy(const __nv_bfloat16* g) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(g)));
}
__device__ __forceinline__ void store_xy(float* g, float2 v) {
  __stcs(reinterpret_cast<float2*>(g), v);
}
__device__ __forceinline__ void store_xy(__nv_bfloat16* g, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(g) = __floats2bfloat162_rn(v.x, v.y);
}

// One pixel of K2b: its corners' image-gradient terms added to the block's
// float32 sums `part` (when given) and its grid gradient from the staged
// source `img` (when given), as the first design summed them.
template <typename T, bool IMG, bool GRD>
__device__ __forceinline__ float2 narrow_pixel(float gx, float gy,
                                               const float* g, int C,
                                               const T* img, float* part,
                                               int H, int W, int align,
                                               float fx, float fy) {
  int idx[4];
  float wgt[4], dwx[4], dwy[4];
  corners(gx, gy, H, W, align, idx, wgt, dwx, dwy);
  float ax = 0.f, ay = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (idx[c] < 0) continue;
    const int off = idx[c] * C;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= C) break;
      if constexpr (IMG) atomicAdd(part + off + j, wgt[c] * g[j]);
      if constexpr (GRD) dot = fmaf(g[j], to_float(img[off + j]), dot);
    }
    ax = fmaf(dot, dwx[c], ax);
    ay = fmaf(dot, dwy[c], ay);
  }
  return make_float2(ax * fx, ay * fy);
}

// K2b: persistent blocks, block (x, s) for source s, whose grids' pixels
// it walks kNarrowPixels tiles of a block's threads at a time: thread t
// takes pixels x * threads * kNarrowPixels + u * threads + t (u <
// kNarrowPixels), then gridDim.x * threads * kNarrowPixels further on,
// neighbouring lanes on neighbouring pixels, each thread's loads issued
// before its arithmetic.  C up to 8, fixed at compile time when CC > 0.
// With GRD the block stages the source's bytes as they are in shared
// memory; with IMG it adds the source's gradient into float32 sums there,
// which the cluster of the source's blocks (gridDim.x of them) adds up in
// block order through distributed shared memory and writes once in the
// image type.
template <typename T, typename G, int CC, bool IMG, bool GRD>
__global__ void __launch_bounds__(kNarrowThreads<IMG>, IMG ? 2 : 1)
warp_narrow_backward_kernel(const T* __restrict__ src,
                            const G* __restrict__ grid,
                            const T* __restrict__ gout, T* __restrict__ gsrc,
                            G* __restrict__ ggrid, int n_px, int H, int W,
                            int C_arg, int align, NarrowOut lay) {
  constexpr int kThreads = kNarrowThreads<IMG>;
  constexpr int kTile = kThreads * kNarrowPixels;
  const int C = CC > 0 ? CC : C_arg;
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.y;
  const int HWC = H * W * C;
  float* const part = reinterpret_cast<float*>(smem);
  unsigned char* const staged =
      smem + (IMG ? ((size_t)HWC * sizeof(float) + 15) / 16 * 16 : 0);
  const T* const src_s = src + (size_t)s * HWC;
  // the source's bytes from the 16-byte boundary at or before it, as
  // 16-byte vectors and then the last few bytes one by one
  const int lead = (int)(reinterpret_cast<uintptr_t>(src_s) & 15);
  const unsigned char* const from =
      reinterpret_cast<const unsigned char*>(src_s) - lead;
  const int end = lead + HWC * (int)sizeof(T);
  const T* const img = reinterpret_cast<const T*>(staged + lead);
  if constexpr (GRD) {
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

  // the source's grids are its group of whole images, from image s * group
  const long long lo = (long long)s * n_px;
  const T* const go = gout + lo * C;
  const G* const gr = grid + lo * 2;
  G* const gg = GRD ? ggrid + lo * 2 : nullptr;
  const long long first = (long long)s * (n_px / lay.P);
  // grad_out's channel 0 of pixel p of the source; channel j lies
  // j * step further on
  const long long step = lay.dense ? 1 : lay.channel;
  auto at = [&](int p) -> const T* {
    if (lay.dense) return go + p * C;
    const int b = p / lay.P;
    return gout + (first + b) * lay.image + (p - b * lay.P) * lay.pixel;
  };
  const float fx = scale_of(W, align), fy = scale_of(H, align);
  for (int p0 = blockIdx.x * kTile + threadIdx.x; p0 < n_px;
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
  if constexpr (IMG) {
    // each block sums its share of the elements over the cluster's
    // blocks, in block order, and writes them once in the image type
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int n = (int)cluster.num_blocks();
    T* const out = gsrc + (size_t)s * HWC;
    for (int i = (int)cluster.block_rank() * kThreads + threadIdx.x; i < HWC;
         i += n * kThreads) {
      float v = 0.f;
      for (int b = 0; b < n; ++b) v += cluster.map_shared_rank(part, b)[i];
      out[i] = from_float<T>(v);
    }
    cluster.sync();                     // no block leaves while read
  }
}

// K2b's launch, as ops/warp_cuda.py narrow_backward_plan makes it:
// `blocks` a source (with gsrc, a cluster of them), `smem` bytes each.
struct Args {
  const void* src;
  const void* grid;
  const void* gout;
  void* gsrc;         // grad_image in the image type, or null
  void* ggrid;        // grad_grid, or null
  int B, Ho, Wo, group, H, W, C, align, blocks, smem;
  NarrowOut lay;
  cudaStream_t stream;
};

// K1b's launch: gsrc is grad_image in the image type (no accumulator);
// work holds the bins and the dots, carved as wide_layout says.
struct WideArgs {
  const void* src;
  const void* grid;
  const void* gout;
  void* gsrc;
  void* ggrid;
  int* work;
  long long work_ints;
  int B, Ho, Wo, group, H, W, C, align;
  cudaStream_t stream;
};

// The workspace in ints, as ops/warp_cuda.py wide_backward_plan computes
// it: bin counts, bin offsets (one more), padding to 8 bytes, each output
// pixel's (bin, rank), the bins' list of pixels, then with the grid
// gradient the dots [slices, B*Ho*Wo, 4] as floats.
struct WideLayout {
  int tiles_x, tiles_y, bins_x, bins, n_bins, slices;
  long long BP, offsets, slot, list, dots, ints;
};

WideLayout wide_layout(const WideArgs& a) {
  WideLayout l;
  l.tiles_x = (a.W + kTile - 1) / kTile;
  l.tiles_y = (a.H + kTile - 1) / kTile;
  l.bins_x = l.tiles_x + 1;
  l.bins = (l.tiles_y + 1) * l.bins_x;
  l.n_bins = (a.B / a.group) * l.bins;
  l.slices = (a.C + kSlice - 1) / kSlice;
  l.BP = (long long)a.B * a.Ho * a.Wo;
  l.offsets = l.n_bins;
  const long long head = 2LL * l.n_bins + 1;
  l.slot = head + (head & 1);
  l.list = l.slot + 2 * l.BP;
  l.dots = l.list + l.BP;
  l.ints = l.dots + (a.ggrid != nullptr ? 4LL * l.slices * l.BP : 0);
  return l;
}

// Let `kernel` take `bytes` of dynamic shared memory, once per device, so
// that a launch (or a CUDA graph's capture of it) makes no other runtime
// call; `attributed` is the kernel's own record of the device.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int& attributed) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || attributed == device) return err;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
      cudaSuccess)
    return err;
  attributed = device;
  return cudaSuccess;
}

// Bins, gather, then the grid gradient.
template <typename T, typename G>
cudaError_t launch_wide(const WideArgs& a) {
  const WideLayout l = wide_layout(a);
  if (a.work_ints < l.ints) return cudaErrorInvalidValue;
  int* counts = a.work;
  int* offsets = a.work + l.offsets;
  int2* slot = reinterpret_cast<int2*>(a.work + l.slot);
  int* list = a.work + l.list;
  float* dots =
      a.ggrid != nullptr ? reinterpret_cast<float*>(a.work + l.dots) : nullptr;
  const G* grid = static_cast<const G*>(a.grid);
  const int P = a.Ho * a.Wo;
  const long long need = (l.BP + kBinThreads - 1) / kBinThreads;
  const int bin_blocks = (int)(need < 4096 ? need : 4096);
  cudaError_t err =
      cudaMemsetAsync(counts, 0, (size_t)l.n_bins * sizeof(int), a.stream);
  if (err != cudaSuccess) return err;
  bin_count_kernel<G><<<bin_blocks, kBinThreads, 0, a.stream>>>(
      grid, counts, slot, l.BP, P, a.group, a.H, a.W, a.align, l.bins_x,
      l.bins);
  bin_scan_kernel<<<1, kScanThreads, 0, a.stream>>>(counts, offsets,
                                                    l.n_bins);
  bin_place_kernel<<<bin_blocks, kBinThreads, 0, a.stream>>>(slot, offsets,
                                                              list, l.BP);
  auto gather = warp_wide_backward_kernel<T, G>;
  constexpr int kPlane = kTile * kTile * kSlice * (int)sizeof(float);
  static int attributed = -1;
  if ((err = allow_smem(gather, 2 * kPlane, attributed)) != cudaSuccess)
    return err;
  const int smem = (a.gsrc != nullptr ? kPlane : 0) +
                   (a.ggrid != nullptr ? kPlane : 0);
  gather<<<dim3(l.tiles_x * l.tiles_y, a.B / a.group, l.slices),
           kGatherThreads, smem, a.stream>>>(
      static_cast<const T*>(a.src), grid, static_cast<const T*>(a.gout),
      static_cast<T*>(a.gsrc), dots, offsets, list, l.BP, a.H, a.W, a.C,
      a.align, l.tiles_x, l.bins_x, l.bins);
  if (a.ggrid != nullptr)
    grid_grad_kernel<G><<<bin_blocks, kBinThreads, 0, a.stream>>>(
        grid, dots, static_cast<G*>(a.ggrid), l.BP, l.slices, a.H, a.W,
        a.align);
  return cudaGetLastError();
}

// K2b's kernel for (T, G, CC, IMG, GRD): `run` launches it (with IMG,
// the blocks of a source as one cluster); `resident` is the blocks the
// card holds at once with `smem` bytes of dynamic shared memory each.
template <typename T, typename G, int CC, bool IMG, bool GRD>
struct NarrowKernel {
  static cudaError_t allow(int& device) {
    static int attributed = -1;
    const cudaError_t err = allow_smem(
        warp_narrow_backward_kernel<T, G, CC, IMG, GRD>, kMaxSmem, attributed);
    device = attributed;
    return err;
  }
  static cudaError_t run(const Args& a) {
    int device = 0;
    cudaError_t err = allow(device);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.blocks, a.B / a.group);
    cfg.blockDim = dim3(kNarrowThreads<IMG>);
    cfg.dynamicSmemBytes = (size_t)a.smem;
    cfg.stream = a.stream;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = (unsigned)a.blocks;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    if (IMG) {
      cfg.attrs = cluster;
      cfg.numAttrs = 1;
    }
    return cudaLaunchKernelEx(
        &cfg, warp_narrow_backward_kernel<T, G, CC, IMG, GRD>,
        static_cast<const T*>(a.src), static_cast<const G*>(a.grid),
        static_cast<const T*>(a.gout), static_cast<T*>(a.gsrc),
        static_cast<G*>(a.ggrid), a.group * a.Ho * a.Wo, a.H, a.W, a.C,
        a.align, a.lay);
  }
  static cudaError_t resident(int smem, int* out) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = allow(device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, warp_narrow_backward_kernel<T, G, CC, IMG, GRD>,
          kNarrowThreads<IMG>, smem);
    *out = sms * per_sm;
    return err;
  }
};

// fn(NarrowKernel<T, G, CC, IMG, GRD>()) for the dtypes (0 float32, 1
// bfloat16), C (3 fixed at compile time, else any C up to 8) and the
// gradients asked for.
template <typename T, typename G, int CC, typename Fn>
cudaError_t by_need(bool img, bool grd, Fn&& fn) {
  if (img && grd) return fn(NarrowKernel<T, G, CC, true, true>());
  if (img) return fn(NarrowKernel<T, G, CC, true, false>());
  return fn(NarrowKernel<T, G, CC, false, true>());
}

template <typename T, typename G, typename Fn>
cudaError_t by_c(int C, bool img, bool grd, Fn&& fn) {
  return C == 3 ? by_need<T, G, 3>(img, grd, fn)
                : by_need<T, G, 0>(img, grd, fn);
}

template <typename Fn>
cudaError_t narrow_dispatch(int dtype, int gdtype, int C, bool img, bool grd,
                            Fn&& fn) {
  if (dtype == 0)
    return gdtype == 0 ? by_c<float, float>(C, img, grd, fn)
                       : by_c<float, __nv_bfloat16>(C, img, grd, fn);
  return gdtype == 0 ? by_c<__nv_bfloat16, float>(C, img, grd, fn)
                     : by_c<__nv_bfloat16, __nv_bfloat16>(C, img, grd, fn);
}

// 32-bit index math inside one source and one grid, and B in gridDim.y.
bool fits(int B, int Ho, int Wo, int group, int H, int W, int C) {
  return B >= 1 && B <= 65535 && group >= 1 && B % group == 0 &&
         (long long)H * W * C <= INT_MAX &&
         (long long)group * Ho * Wo * (C < 2 ? 2 : C) <= INT_MAX;
}

}  // namespace

// grad_out [B,Ho,Wo,C] of warp_wide -> grad_image [B/group,H,W,C] in the
// image type (when gsrc is given) and grad_grid (when ggrid is given), by
// K1b's gather; work: work_ints ints of scratch (ops/warp_cuda.py
// wide_backward_plan).  C % 8 == 0.  dtype (image, grad_out, grad_image)
// and gdtype (grid, grad_grid): 0 float32, 1 bfloat16.  Returns the
// launches' cudaError_t.
extern "C" int eamm_warp_wide_backward(const void* src, const void* grid,
                                       const void* gout, void* gsrc,
                                       void* ggrid, void* work,
                                       long long work_ints, int dtype,
                                       int gdtype, int B, int Ho, int Wo,
                                       int group, int H, int W, int C,
                                       int align, void* stream) {
  if (C % 8 != 0 || !fits(B, Ho, Wo, group, H, W, C) || (!gsrc && !ggrid) ||
      (long long)B * Ho * Wo > INT_MAX || (dtype != 0 && dtype != 1) ||
      (gdtype != 0 && gdtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear any earlier error of this runtime
  const WideArgs a{src, grid, gout, gsrc, ggrid, static_cast<int*>(work),
                   work_ints, B, Ho, Wo, group, H, W, C, align,
                   static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == 0)
    err = gdtype == 0 ? launch_wide<float, float>(a)
                      : launch_wide<float, __nv_bfloat16>(a);
  else
    err = gdtype == 0 ? launch_wide<__nv_bfloat16, float>(a)
                      : launch_wide<__nv_bfloat16, __nv_bfloat16>(a);
  return (int)err;
}

// K2b: grad_out [B,Ho,Wo,C] of warp_narrow -> grad_image
// [B/group,H,W,C] in the image type (when gsrc is given) and grad_grid
// (when ggrid is given); 1 <= C <= 8.  grad_out's element (b, pixel q
// of Ho * Wo, channel j) lies at b * gout_image + q * gout_pixel +
// j * gout_channel.  `blocks` a source (with
// gsrc, at most 8: one cluster) and `smem` bytes of dynamic shared
// memory a block, as ops/warp_cuda.py narrow_backward_plan makes them.
// dtype and gdtype as eamm_warp_wide_backward's.  Returns the launch's
// cudaError_t.
extern "C" int eamm_warp_narrow_backward(const void* src, const void* grid,
                                         const void* gout, void* gsrc,
                                         void* ggrid, int dtype, int gdtype,
                                         int B, int Ho, int Wo, int group,
                                         int H, int W, int C, int align,
                                         long long gout_image,
                                         long long gout_pixel,
                                         long long gout_channel, int blocks,
                                         int smem, void* stream) {
  const NarrowOut lay{gout_image == (long long)Ho * Wo * C &&
                          gout_pixel == C && gout_channel == 1,
                      Ho * Wo, gout_image, gout_pixel, gout_channel};
  if (C < 1 || C > 8 || !fits(B, Ho, Wo, group, H, W, C) ||
      (!gsrc && !ggrid) || blocks < 1 || (gsrc && blocks > 8) || smem < 0 ||
      smem > kMaxSmem || (dtype != 0 && dtype != 1) ||
      (gdtype != 0 && gdtype != 1) || gout_image < 0 || gout_pixel < 0 ||
      gout_channel < 0)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear any earlier error of this runtime
  const Args a{src, grid, gout, gsrc, ggrid, B, Ho, Wo, group, H, W, C,
               align, blocks, smem, lay, static_cast<cudaStream_t>(stream)};
  return (int)narrow_dispatch(dtype, gdtype, C, gsrc != nullptr,
                              ggrid != nullptr,
                              [&](auto k) { return k.run(a); });
}

// The blocks of K2b's kernel for these dtypes, C and gradients that the
// card holds at once with `smem` bytes of dynamic shared memory each,
// into *resident; lets the kernel take that much.  Returns a cudaError_t.
extern "C" int eamm_warp_narrow_backward_resident(int dtype, int gdtype,
                                                  int C, int need_image,
                                                  int need_grid, int smem,
                                                  int* resident) {
  if (C < 1 || C > 8 || (!need_image && !need_grid) || smem < 0 ||
      smem > kMaxSmem || (dtype != 0 && dtype != 1) ||
      (gdtype != 0 && gdtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();
  return (int)narrow_dispatch(
      dtype, gdtype, C, need_image != 0, need_grid != 0,
      [&](auto k) { return k.resident(smem, resident); });
}

extern "C" const char* eamm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
