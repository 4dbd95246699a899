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
// What bounds them on an H100: both write far more than they read (the
// sources are small and stay in L2), so each is bound by the bytes of its
// output and grid at 3.35 TB/s.  Design against that:
//   warp_wide: a thread owns 8 channels of one output pixel, so one warp
//   covers 256 channels and every corner read and every store is one
//   16-byte access per thread, 512 B coalesced per warp (bf16).
//   warp_narrow: a thread owns one output pixel and all its C channels;
//   neighbouring threads write neighbouring pixels.
//   warp_groups (C not a multiple of 8, e.g. 35): pixel rows are not
//   16-byte aligned, so a thread owns up to 8 channels of one pixel and
//   reads and writes them one by one; neighbouring threads still cover
//   neighbouring addresses.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// The _rn intrinsics keep nvcc from contracting these into an FMA, so the
// pixel coordinate rounds exactly as in the plain version.
__device__ __forceinline__ float unnormalize(float g, int size, int align) {
  const float g1 = __fadd_rn(g, 1.f);
  return align ? __fmul_rn(__fmul_rn(g1, 0.5f), (float)(size - 1))
               : __fmul_rn(__fsub_rn(__fmul_rn(g1, (float)size), 1.f), 0.5f);
}

// Corner offsets (pixel index y*W+x, or -1 outside the image) and weights,
// in the order the plain version sums them: (x0,y0) (x1,y0) (x0,y1) (x1,y1).
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

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One thread per (output pixel, 8-channel vector); C % 8 == 0.
template <typename T, typename G>
__global__ void warp_wide_kernel(const T* __restrict__ src,
                                 const G* __restrict__ grid,
                                 T* __restrict__ out, long long n_pix,
                                 int P, int group, int H, int W, int C,
                                 int align) {
  const int vecs = C / 8;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_pix * vecs) return;
  const long long pix = t / vecs;           // b * P + p
  const int v = (int)(t - pix * vecs);
  const int b = (int)(pix / P);
  int idx[4];
  float wgt[4];
  corners(to_float(grid[2 * pix]), to_float(grid[2 * pix + 1]), H, W, align,
          idx, wgt);
  const T* s = src + (long long)(b / group) * H * W * C + v * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (idx[c] < 0) continue;
    float val[8];
    load8(s + (long long)idx[c] * C, val);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(val[j], wgt[c], acc[j]);
  }
  store8(out + pix * C + v * 8, acc);
}

// One thread per output pixel, all C <= 8 channels.
template <typename T, typename G>
__global__ void warp_narrow_kernel(const T* __restrict__ src,
                                   const G* __restrict__ grid,
                                   T* __restrict__ out, long long n_pix,
                                   int P, int group, int H, int W, int C,
                                   int align) {
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pix) return;
  const int b = (int)(pix / P);
  int idx[4];
  float wgt[4];
  corners(to_float(grid[2 * pix]), to_float(grid[2 * pix + 1]), H, W, align,
          idx, wgt);
  const T* s = src + (long long)(b / group) * H * W * C;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (idx[c] < 0) continue;
    const T* corner = s + (long long)idx[c] * C;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < C) acc[j] = fmaf(to_float(corner[j]), wgt[c], acc[j]);
  }
  T* o = out + pix * C;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < C) from_float(o + j, acc[j]);
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
  corners(to_float(grid[2 * pix]), to_float(grid[2 * pix + 1]), H, W, align,
          idx, wgt);
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
    if (j < n) from_float(o + j, acc[j]);
}

constexpr int kThreads = 256;

template <template <typename, typename> class Launch, typename T>
void launch_grid(int gdtype, unsigned blocks, cudaStream_t s, const void* src,
                 const void* grid, void* out, long long n_pix, int P,
                 int group, int H, int W, int C, int align) {
  if (gdtype == 0)
    Launch<T, float>::run(blocks, s, static_cast<const T*>(src),
                          static_cast<const float*>(grid), static_cast<T*>(out),
                          n_pix, P, group, H, W, C, align);
  else
    Launch<T, __nv_bfloat16>::run(blocks, s, static_cast<const T*>(src),
                                  static_cast<const __nv_bfloat16*>(grid),
                                  static_cast<T*>(out), n_pix, P, group, H, W,
                                  C, align);
}

// dtype, gdtype: 0 float32, 1 bfloat16 (image and output; grid).
template <template <typename, typename> class Launch>
int dispatch(int dtype, int gdtype, const void* src, const void* grid,
             void* out, long long n_pix, long long n_threads, int P, int group,
             int H, int W, int C, int align, void* stream) {
  if ((dtype != 0 && dtype != 1) || (gdtype != 0 && gdtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear any earlier error of this runtime
  const unsigned blocks = (unsigned)((n_threads + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_grid<Launch, float>(gdtype, blocks, s, src, grid, out, n_pix, P,
                               group, H, W, C, align);
  else
    launch_grid<Launch, __nv_bfloat16>(gdtype, blocks, s, src, grid, out,
                                       n_pix, P, group, H, W, C, align);
  return (int)cudaGetLastError();
}

template <typename T, typename G>
struct LaunchWide {
  static void run(unsigned blocks, cudaStream_t s, const T* src, const G* grid,
                  T* out, long long n_pix, int P, int group, int H, int W,
                  int C, int align) {
    warp_wide_kernel<T, G><<<blocks, kThreads, 0, s>>>(src, grid, out, n_pix,
                                                       P, group, H, W, C,
                                                       align);
  }
};

template <typename T, typename G>
struct LaunchNarrow {
  static void run(unsigned blocks, cudaStream_t s, const T* src, const G* grid,
                  T* out, long long n_pix, int P, int group, int H, int W,
                  int C, int align) {
    warp_narrow_kernel<T, G><<<blocks, kThreads, 0, s>>>(src, grid, out, n_pix,
                                                         P, group, H, W, C,
                                                         align);
  }
};

template <typename T, typename G>
struct LaunchGroups {
  static void run(unsigned blocks, cudaStream_t s, const T* src, const G* grid,
                  T* out, long long n_pix, int P, int group, int H, int W,
                  int C, int align) {
    warp_groups_kernel<T, G><<<blocks, kThreads, 0, s>>>(src, grid, out, n_pix,
                                                         P, group, H, W, C,
                                                         align);
  }
};

}  // namespace

// B grids of P = Ho*Wo pixels each over Bi images; group = B / Bi.  dtype
// (image, output) and gdtype (grid): 0 float32, 1 bfloat16.  Returns the
// launch's cudaError_t.
extern "C" int eamm_warp_wide(const void* src, const void* grid, void* out,
                              int dtype, int gdtype, int B, int P, int group,
                              int H, int W, int C, int align, void* stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)B * P;
  return dispatch<LaunchWide>(dtype, gdtype, src, grid, out, n_pix,
                              n_pix * (C / 8), P, group, H, W, C, align,
                              stream);
}

extern "C" int eamm_warp_narrow(const void* src, const void* grid, void* out,
                                int dtype, int gdtype, int B, int P, int group,
                                int H, int W, int C, int align, void* stream) {
  if (C < 1 || C > 8) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)B * P;
  return dispatch<LaunchNarrow>(dtype, gdtype, src, grid, out, n_pix, n_pix, P,
                                group, H, W, C, align, stream);
}

// Any C >= 1: the 16-byte kernel when C % 8 == 0, else groups of up to 8
// channels read and written one by one.
extern "C" int eamm_warp_shared(const void* src, const void* grid, void* out,
                                int dtype, int gdtype, int B, int P, int group,
                                int H, int W, int C, int align, void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)B * P;
  if (C % 8 == 0)
    return dispatch<LaunchWide>(dtype, gdtype, src, grid, out, n_pix,
                                n_pix * (C / 8), P, group, H, W, C, align,
                                stream);
  return dispatch<LaunchGroups>(dtype, gdtype, src, grid, out, n_pix,
                                n_pix * ((C + 7) / 8), P, group, H, W, C,
                                align, stream);
}

extern "C" const char* eamm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
