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
// Sums are float32; grad_image is accumulated in a float32 buffer (the
// output itself for a float32 image, else scratch that is then rounded
// once to the image type); grad_grid is written in the grid's type.
//
// What bounds them: grad_image is a scatter, so every (pixel, corner,
// channel) is a float32 read-modify-write in L2 (atomicAdd); at K1b's
// training shape that is 4 x 256 per pixel.  This first version is the
// simple one: K1b keeps the forward's block per 8x8 output tile, with the
// corner offsets, weights and their x and y derivatives computed once per
// pixel in shared memory, and streams (pixel, 16-byte channel vector)
// pairs with one global atomic per corner and channel; a pixel's grid
// gradient is reduced over its channel vectors in shared memory.  K2b
// (C <= 8, small sources) accumulates grad_image for its source in shared
// memory first, so the global atomics are one per source value per block,
// then adds the block's sum to device memory; a thread owns a pixel and
// its C channels, so its grid gradient needs no reduction.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWideTile = 8;            // 8x8 output pixels per block
constexpr int kWidePix = kWideTile * kWideTile;
constexpr int kWideThreads = 256;
constexpr int kNarrowThreads = 256;
constexpr int kNarrowBlocks = 528;      // 4 blocks on each of 132 SMs
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

// VEC values of 16 bytes as floats.
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

// The unnormalize factor: d(pixel coordinate) / d(grid coordinate).
__device__ __forceinline__ float scale_of(int size, int align) {
  return align ? 0.5f * (float)(size - 1) : 0.5f * (float)size;
}

// K1b: one block per 8x8 tile of one grid's output, all C channels;
// C % 8 == 0.  grid: x over tiles, y over B.
template <typename T, typename G>
__global__ void __launch_bounds__(kWideThreads)
warp_wide_backward_kernel(const T* __restrict__ src, const G* __restrict__ grid,
                          const T* __restrict__ gout, float* __restrict__ gsrc,
                          G* __restrict__ ggrid, int Ho, int Wo, int group,
                          int H, int W, int C, int align) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ int s_src[kWidePix][4];    // corner offsets idx*C, or -1
  __shared__ float s_wgt[kWidePix][4];
  __shared__ float s_dx[kWidePix][4];
  __shared__ float s_dy[kWidePix][4];
  __shared__ int s_out[kWidePix];       // pixel offset p*C in the grid
  __shared__ float s_gx[kWidePix];      // the pixel's d(loss)/dx, dy
  __shared__ float s_gy[kWidePix];
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
    const G* g = grid + ((size_t)b * P + p) * 2;
    int idx[4];
    float wgt[4], dwx[4], dwy[4];
    corners(to_float(g[0]), to_float(g[1]), H, W, align, idx, wgt, dwx, dwy);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s_src[t][c] = idx[c] < 0 ? -1 : idx[c] * C;
      s_wgt[t][c] = wgt[c];
      s_dx[t][c] = dwx[c];
      s_dy[t][c] = dwy[c];
    }
    s_out[t] = p * C;
    s_gx[t] = 0.f;
    s_gy[t] = 0.f;
  }
  __syncthreads();
  const size_t src_off = (size_t)(b / group) * H * W * C;
  const T* s = src + src_off;
  float* gs = gsrc ? gsrc + src_off : nullptr;
  const T* go = gout + (size_t)b * P * C;
  const int vecs = C / VEC;
  const int pairs = n_px * vecs;
#pragma unroll 1
  for (int k = t; k < pairs; k += kWideThreads) {
    const int q = k / vecs;
    const int c0 = (k - q * vecs) * VEC;
    float g[VEC];
    unpack(__ldg(reinterpret_cast<const uint4*>(go + s_out[q] + c0)), g, T());
    float ax = 0.f, ay = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int off = s_src[q][c];
      if (off < 0) continue;
      if (gs) {
        const float w = s_wgt[q][c];
#pragma unroll
        for (int j = 0; j < VEC; ++j) atomicAdd(gs + off + c0 + j, w * g[j]);
      }
      if (ggrid) {
        float val[VEC];
        unpack(__ldg(reinterpret_cast<const uint4*>(s + off + c0)), val, T());
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) dot = fmaf(g[j], val[j], dot);
        ax = fmaf(dot, s_dx[q][c], ax);
        ay = fmaf(dot, s_dy[q][c], ay);
      }
    }
    if (ggrid) {
      atomicAdd(&s_gx[q], ax);
      atomicAdd(&s_gy[q], ay);
    }
  }
  if (!ggrid) return;
  __syncthreads();
  if (t < n_px) {
    G* o = ggrid + (size_t)b * P * 2 + s_out[t] / C * 2;
    o[0] = from_float<G>(s_gx[t] * scale_of(W, align));
    o[1] = from_float<G>(s_gy[t] * scale_of(H, align));
  }
}

// K2b: block (x, s) walks pixels x*threads + i*gridDim.x*threads of the
// group * P pixels of the grids that read source s.  With gsrc, the block
// accumulates its part of source s's gradient in shared memory (H*W*C
// floats) and adds it to gsrc at the end.
template <typename T, typename G>
__global__ void __launch_bounds__(kNarrowThreads)
warp_narrow_backward_kernel(const T* __restrict__ src,
                            const G* __restrict__ grid,
                            const T* __restrict__ gout,
                            float* __restrict__ gsrc, G* __restrict__ ggrid,
                            int n_px, int H, int W, int C, int align) {
  extern __shared__ float s_acc[];
  const int s = blockIdx.y;
  const int HWC = H * W * C;
  if (gsrc) {
    for (int i = threadIdx.x; i < HWC; i += kNarrowThreads) s_acc[i] = 0.f;
    __syncthreads();
  }
  const T* src_s = src + (size_t)s * HWC;
  const size_t first = (size_t)s * n_px;     // the source's first pixel
  const float fx = scale_of(W, align), fy = scale_of(H, align);
  for (int p = blockIdx.x * kNarrowThreads + threadIdx.x; p < n_px;
       p += gridDim.x * kNarrowThreads) {
    const G* g2 = grid + (first + p) * 2;
    int idx[4];
    float wgt[4], dwx[4], dwy[4];
    corners(to_float(g2[0]), to_float(g2[1]), H, W, align, idx, wgt, dwx, dwy);
    const T* go = gout + (first + p) * C;
    float g[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) g[j] = j < C ? to_float(go[j]) : 0.f;
    float ax = 0.f, ay = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (idx[c] < 0) continue;
      const int off = idx[c] * C;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= C) break;
        if (gsrc) atomicAdd(&s_acc[off + j], wgt[c] * g[j]);
        if (ggrid) dot = fmaf(g[j], to_float(__ldg(src_s + off + j)), dot);
      }
      ax = fmaf(dot, dwx[c], ax);
      ay = fmaf(dot, dwy[c], ay);
    }
    if (ggrid) {
      G* o = ggrid + (first + p) * 2;
      o[0] = from_float<G>(ax * fx);
      o[1] = from_float<G>(ay * fy);
    }
  }
  if (!gsrc) return;
  __syncthreads();
  float* gs = gsrc + (size_t)s * HWC;
  for (int i = threadIdx.x; i < HWC; i += kNarrowThreads) {
    const float v = s_acc[i];
    if (v != 0.f) atomicAdd(gs + i, v);
  }
}

// grad_image rounded once from its float32 accumulator.
__global__ void round_kernel(const float* __restrict__ in,
                             __nv_bfloat16* __restrict__ out, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16_rn(in[i]);
}

struct Args {
  const void* src;
  const void* grid;
  const void* gout;
  float* gsrc;        // float32 accumulator of grad_image, or null
  void* gsrc_out;     // grad_image in the image type (== gsrc for float32)
  void* ggrid;        // grad_grid, or null
  int B, Ho, Wo, group, H, W, C, align;
  cudaStream_t stream;
};

template <typename T, typename G>
cudaError_t launch_wide(const Args& a) {
  const int tiles = ((a.Ho + kWideTile - 1) / kWideTile) *
                    ((a.Wo + kWideTile - 1) / kWideTile);
  warp_wide_backward_kernel<T, G>
      <<<dim3(tiles, a.B), kWideThreads, 0, a.stream>>>(
          static_cast<const T*>(a.src), static_cast<const G*>(a.grid),
          static_cast<const T*>(a.gout), a.gsrc, static_cast<G*>(a.ggrid),
          a.Ho, a.Wo, a.group, a.H, a.W, a.C, a.align);
  return cudaGetLastError();
}

template <typename T, typename G>
cudaError_t launch_narrow(const Args& a) {
  auto kernel = warp_narrow_backward_kernel<T, G>;
  const int smem = a.gsrc ? a.H * a.W * a.C * (int)sizeof(float) : 0;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // let the kernel take the opt-in maximum once per device, so that a
  // launch (or a CUDA graph's capture of it) makes no other runtime call
  static int attributed = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (attributed != device) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kMaxSmem)) != cudaSuccess)
      return err;
    attributed = device;
  }
  const int n_px = a.group * a.Ho * a.Wo;
  const int Bi = a.B / a.group;
  const int most = (n_px + kNarrowThreads - 1) / kNarrowThreads;
  const int blocks = max(1, min(most, (kNarrowBlocks + Bi - 1) / Bi));
  kernel<<<dim3(blocks, Bi), kNarrowThreads, smem, a.stream>>>(
      static_cast<const T*>(a.src), static_cast<const G*>(a.grid),
      static_cast<const T*>(a.gout), a.gsrc, static_cast<G*>(a.ggrid), n_px,
      a.H, a.W, a.C, a.align);
  return cudaGetLastError();
}

template <typename T, typename G>
struct Wide { static cudaError_t run(const Args& a) { return launch_wide<T, G>(a); } };
template <typename T, typename G>
struct Narrow { static cudaError_t run(const Args& a) { return launch_narrow<T, G>(a); } };

// Zero the accumulator, run the kernel, round the accumulator to bfloat16
// where the image is bfloat16.  dtype (image, grad_out, grad_image) and
// gdtype (grid, grad_grid): 0 float32, 1 bfloat16.
template <template <typename, typename> class Launch>
int dispatch(int dtype, int gdtype, const Args& a) {
  if ((dtype != 0 && dtype != 1) || (gdtype != 0 && gdtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear any earlier error of this runtime
  const long long n_src = (long long)(a.B / a.group) * a.H * a.W * a.C;
  cudaError_t err;
  if (a.gsrc &&
      (err = cudaMemsetAsync(a.gsrc, 0, n_src * sizeof(float), a.stream)) !=
          cudaSuccess)
    return (int)err;
  if (dtype == 0)
    err = gdtype == 0 ? Launch<float, float>::run(a)
                      : Launch<float, __nv_bfloat16>::run(a);
  else
    err = gdtype == 0 ? Launch<__nv_bfloat16, float>::run(a)
                      : Launch<__nv_bfloat16, __nv_bfloat16>::run(a);
  if (err != cudaSuccess || !a.gsrc || dtype == 0) return (int)err;
  const long long need = (n_src + 255) / 256;
  const long long blocks = need < 4096 ? need : 4096;
  round_kernel<<<(unsigned)blocks, 256, 0, a.stream>>>(
      a.gsrc, static_cast<__nv_bfloat16*>(a.gsrc_out), n_src);
  return (int)cudaGetLastError();
}

// 32-bit index math inside one source and one grid, and B in gridDim.y.
bool fits(int B, int Ho, int Wo, int group, int H, int W, int C) {
  return B >= 1 && B <= 65535 && group >= 1 && B % group == 0 &&
         (long long)H * W * C <= INT_MAX &&
         (long long)group * Ho * Wo * (C < 2 ? 2 : C) <= INT_MAX;
}

}  // namespace

// grad_out [B,Ho,Wo,C] of warp_wide -> grad_image (when gsrc is given:
// its float32 accumulator, [B/group,H,W,C], and gsrc_out, the output in
// the image type, the same pointer for float32) and grad_grid (when ggrid
// is given).  C % 8 == 0.  Returns the launches' cudaError_t.
extern "C" int eamm_warp_wide_backward(const void* src, const void* grid,
                                       const void* gout, void* gsrc,
                                       void* gsrc_out, void* ggrid, int dtype,
                                       int gdtype, int B, int Ho, int Wo,
                                       int group, int H, int W, int C,
                                       int align, void* stream) {
  if (C % 8 != 0 || !fits(B, Ho, Wo, group, H, W, C) || (!gsrc && !ggrid))
    return (int)cudaErrorInvalidValue;
  return dispatch<Wide>(dtype, gdtype,
                        {src, grid, gout, static_cast<float*>(gsrc), gsrc_out,
                         ggrid, B, Ho, Wo, group, H, W, C, align,
                         static_cast<cudaStream_t>(stream)});
}

// The same for warp_narrow: 1 <= C <= 8, and with gsrc a source's H*W*C
// floats must fit in one block's shared memory.
extern "C" int eamm_warp_narrow_backward(const void* src, const void* grid,
                                         const void* gout, void* gsrc,
                                         void* gsrc_out, void* ggrid,
                                         int dtype, int gdtype, int B, int Ho,
                                         int Wo, int group, int H, int W,
                                         int C, int align, void* stream) {
  if (C < 1 || C > 8 || !fits(B, Ho, Wo, group, H, W, C) ||
      (!gsrc && !ggrid))
    return (int)cudaErrorInvalidValue;
  return dispatch<Narrow>(dtype, gdtype,
                          {src, grid, gout, static_cast<float*>(gsrc),
                           gsrc_out, ggrid, B, Ho, Wo, group, H, W, C, align,
                           static_cast<cudaStream_t>(stream)});
}

extern "C" const char* eamm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
