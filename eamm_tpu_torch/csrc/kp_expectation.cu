// Keypoint expectation for NVIDIA Hopper, two kernels.
//
// Replaces the TPU kernels
//   kp_expectation       <- eamm_tpu/ops/kp_expectation.py: kp_expectation ->
//                           _pallas_impl -> _kernel (forward only; training's
//                           backward is a later port);
//   kp_expectation_fused <- eamm_tpu/ops/kp_pallas.py: kp_expectation_fused
//                           -> _kernel (float32 or bfloat16 inputs, and the
//                           normalized heatmap on request).
// Per (b, k) row of P = h*w logits:
//   heat      = softmax(pred / temperature)
//   value     = sum heat * (2x/(w-1) - 1, 2y/(h-1) - 1),  x = p % w, y = p / w
//   jacobian  = sum heat * jmap[f],  f = 0..3
// computed as sums of e = exp(logit - max) divided by sum e at the end.
//
// What bounds them on an H100: they read 5 values per pixel and write 6
// floats per row (and, for the heatmap, one value per pixel), so they are
// bound by their bytes at 3.35 TB/s (the audio head at 256 frames reads
// 172 MB).  Design against that: one block per row, each input byte read
// from device memory once (kp_expectation's max pass pulls the row into
// L1/L2 and the second pass reads it there; kp_expectation_fused keeps the
// row's scaled logits, then their exponentials, in shared memory, 13 KB
// for 58x58, so the heatmap store needs no third read), coalesced along the
// row; the grid coordinates come from the index, not from memory; no
// padding.  The inputs are read in place through their strides, so a conv
// output [B, K + 4K, h, w] feeds pred = y[:, :K] and jmap = y[:, K:]
// uncopied.  The TPU kernel's -1e9 lane and row padding is TPU layout and
// has no counterpart here.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 7;  // sum e, e*gx, e*gy, e*jmap[0..3]

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's max of v, on every thread.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) scratch[wid] = v;
  __syncthreads();
  float m = scratch[0];
  for (int i = 1; i < kWarps; ++i) m = fmaxf(m, scratch[i]);
  __syncthreads();  // scratch may be written again
  return m;
}

// The block's sums of s[0..kSums), left in s on every thread; the warps'
// partial sums are added in warp order, so the result does not depend on
// scheduling.
__device__ __forceinline__ void block_sums(float (&s)[kSums],
                                           float (*partial)[kSums]) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    const float v = warp_sum(s[i]);
    if (lane == 0) partial[wid][i] = v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    float t = 0.f;
    for (int j = 0; j < kWarps; ++j) t += partial[j][i];
    s[i] = t;
  }
}

// Adds pixel p's terms, weighted by e, to s.
template <typename TJ>
__device__ __forceinline__ void accumulate(float (&s)[kSums], float e, int p,
                                           int h, int w, const TJ* jm,
                                           long long jmap_f) {
  const int y = p / w, x = p - y * w;
  s[0] += e;
  s[1] += e * (2.f * __fdiv_rn((float)x, (float)(w - 1)) - 1.f);
  s[2] += e * (2.f * __fdiv_rn((float)y, (float)(h - 1)) - 1.f);
#pragma unroll
  for (int f = 0; f < 4; ++f) s[3 + f] += e * to_float(jm[f * jmap_f + p]);
}

__device__ __forceinline__ void store_row(const float (&s)[kSums], int row,
                                          float* value, float* jac) {
  if (threadIdx.x == 0) {
    const float inv = 1.f / s[0];
    value[2 * row] = s[1] * inv;
    value[2 * row + 1] = s[2] * inv;
#pragma unroll
    for (int f = 0; f < 4; ++f) jac[4 * row + f] = s[3 + f] * inv;
  }
}

__global__ void kp_expectation_kernel(
    const float* __restrict__ pred, long long pred_b, long long pred_k,
    const float* __restrict__ jmap, long long jmap_b, long long jmap_k,
    long long jmap_f, float* __restrict__ value, float* __restrict__ jac,
    int K, int h, int w, float temp) {
  __shared__ float scratch[kWarps];
  __shared__ float partial[kWarps][kSums];
  const int row = blockIdx.x;
  const int b = row / K, k = row % K;
  const int P = h * w;
  const float* pr = pred + b * pred_b + k * pred_k;
  const float* jm = jmap + b * jmap_b + k * jmap_k;

  float m = -INFINITY;
  for (int p = threadIdx.x; p < P; p += kThreads) m = fmaxf(m, __fdiv_rn(pr[p], temp));
  m = block_max(m, scratch);

  float s[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int p = threadIdx.x; p < P; p += kThreads)
    accumulate(s, expf(__fdiv_rn(pr[p], temp) - m), p, h, w, jm, jmap_f);
  block_sums(s, partial);
  store_row(s, row, value, jac);
}

// heat: [B*K, P] contiguous in the prediction's type, or null.
template <typename TP, typename TJ>
__global__ void kp_expectation_fused_kernel(
    const TP* __restrict__ pred, long long pred_b, long long pred_k,
    const TJ* __restrict__ jmap, long long jmap_b, long long jmap_k,
    long long jmap_f, float* __restrict__ value, float* __restrict__ jac,
    TP* __restrict__ heat, int K, int h, int w, float temp) {
  extern __shared__ float logits[];  // the row's P scaled logits, then e
  __shared__ float scratch[kWarps];
  __shared__ float partial[kWarps][kSums];
  const int row = blockIdx.x;
  const int b = row / K, k = row % K;
  const int P = h * w;
  const TP* pr = pred + b * pred_b + k * pred_k;
  const TJ* jm = jmap + b * jmap_b + k * jmap_k;

  // each thread reads back only the entries it wrote itself
  float m = -INFINITY;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const float l = __fdiv_rn(to_float(pr[p]), temp);
    logits[p] = l;
    m = fmaxf(m, l);
  }
  m = block_max(m, scratch);

  float s[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const float e = expf(logits[p] - m);
    logits[p] = e;
    accumulate(s, e, p, h, w, jm, jmap_f);
  }
  block_sums(s, partial);
  store_row(s, row, value, jac);
  if (heat != nullptr) {
    TP* hr = heat + (long long)row * P;
    for (int p = threadIdx.x; p < P; p += kThreads)
      from_float(hr + p, __fdiv_rn(logits[p], s[0]));
  }
}

template <typename TP, typename TJ>
int launch_fused(const void* pred, long long pred_b, long long pred_k,
                 const void* jmap, long long jmap_b, long long jmap_k,
                 long long jmap_f, void* value, void* jac, void* heat, int B,
                 int K, int h, int w, float temp, cudaStream_t stream) {
  const size_t smem = (size_t)h * w * sizeof(float);
  auto kernel = kp_expectation_fused_kernel<TP, TJ>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B * K, kThreads, smem, stream>>>(
      static_cast<const TP*>(pred), pred_b, pred_k,
      static_cast<const TJ*>(jmap), jmap_b, jmap_k, jmap_f,
      static_cast<float*>(value), static_cast<float*>(jac),
      static_cast<TP*>(heat), K, h, w, temp);
  return (int)cudaGetLastError();
}

}  // namespace

// pred row (b, k) starts at pred + b*pred_b + k*pred_k; jmap row (b, k, f) at
// jmap + b*jmap_b + k*jmap_k + f*jmap_f; both rows hold h*w contiguous
// floats.  value: [B*K*2], jac: [B*K*4].  Returns the launch's cudaError_t.
extern "C" int eamm_kp_expectation(const void* pred, long long pred_b,
                                   long long pred_k, const void* jmap,
                                   long long jmap_b, long long jmap_k,
                                   long long jmap_f, void* value, void* jac,
                                   int B, int K, int h, int w, float temp,
                                   void* stream) {
  cudaGetLastError();  // clear any earlier error of this runtime
  kp_expectation_kernel<<<B * K, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pred), pred_b, pred_k,
      static_cast<const float*>(jmap), jmap_b, jmap_k, jmap_f,
      static_cast<float*>(value), static_cast<float*>(jac), K, h, w, temp);
  return (int)cudaGetLastError();
}

// As eamm_kp_expectation, with pdtype and jdtype (0 float32, 1 bfloat16) for
// pred and jmap, and heat: null, or [B*K*h*w] in pred's type for the
// normalized heatmap.  h*w floats of dynamic shared memory per block.
extern "C" int eamm_kp_expectation_fused(
    const void* pred, int pdtype, long long pred_b, long long pred_k,
    const void* jmap, int jdtype, long long jmap_b, long long jmap_k,
    long long jmap_f, void* value, void* jac, void* heat, int B, int K, int h,
    int w, float temp, void* stream) {
  if ((pdtype != 0 && pdtype != 1) || (jdtype != 0 && jdtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear any earlier error of this runtime
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pdtype == 0 && jdtype == 0)
    return launch_fused<float, float>(pred, pred_b, pred_k, jmap, jmap_b,
                                      jmap_k, jmap_f, value, jac, heat, B, K,
                                      h, w, temp, s);
  if (pdtype == 0)
    return launch_fused<float, __nv_bfloat16>(pred, pred_b, pred_k, jmap,
                                              jmap_b, jmap_k, jmap_f, value,
                                              jac, heat, B, K, h, w, temp, s);
  if (jdtype == 0)
    return launch_fused<__nv_bfloat16, float>(pred, pred_b, pred_k, jmap,
                                              jmap_b, jmap_k, jmap_f, value,
                                              jac, heat, B, K, h, w, temp, s);
  return launch_fused<__nv_bfloat16, __nv_bfloat16>(
      pred, pred_b, pred_k, jmap, jmap_b, jmap_k, jmap_f, value, jac, heat, B,
      K, h, w, temp, s);
}

extern "C" const char* eamm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
