// Keypoint expectation for NVIDIA Hopper.
//
// Replaces the TPU kernel eamm_tpu/ops/kp_expectation.py: kp_expectation ->
// _pallas_impl -> _kernel (forward only; training's backward is a later
// port).  Per (b, k) row of P = h*w logits:
//   heat      = softmax(pred / temperature)
//   value     = sum heat * (2x/(w-1) - 1, 2y/(h-1) - 1),  x = p % w, y = p / w
//   jacobian  = sum heat * jmap[f],  f = 0..3
// computed as sums of e = exp(logit - max) divided by sum e at the end.
//
// What bounds it on an H100: it reads 5 floats per pixel and writes 6 per
// row, so it is bound by its input bytes at 3.35 TB/s (the audio head at
// 256 frames reads 172 MB).  Design against that: one block per row, each
// input byte read from device memory once (the max pass pulls the row into
// L1/L2, the second pass reads it there), coalesced along the row; the grid
// coordinates come from the index, not from memory; no padding.  The
// inputs are read in place through their strides, so a conv output
// [B, K + 4K, h, w] feeds pred = y[:, :K] and jmap = y[:, K:] uncopied.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSums = 7;  // sum e, e*gx, e*gy, e*jmap[0..3]

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

__global__ void kp_expectation_kernel(
    const float* __restrict__ pred, long long pred_b, long long pred_k,
    const float* __restrict__ jmap, long long jmap_b, long long jmap_k,
    long long jmap_f, float* __restrict__ value, float* __restrict__ jac,
    int K, int h, int w, float temp) {
  __shared__ float partial[kThreads / 32][kSums];
  __shared__ float row_max;
  const int row = blockIdx.x;
  const int b = row / K, k = row % K;
  const int P = h * w;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const float* pr = pred + b * pred_b + k * pred_k;
  const float* jm = jmap + b * jmap_b + k * jmap_k;

  float m = -INFINITY;
  for (int p = threadIdx.x; p < P; p += kThreads) m = fmaxf(m, __fdiv_rn(pr[p], temp));
  m = warp_max(m);
  if (lane == 0) partial[wid][0] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float mm = partial[0][0];
    for (int i = 1; i < kThreads / 32; ++i) mm = fmaxf(mm, partial[i][0]);
    row_max = mm;
  }
  __syncthreads();
  m = row_max;

  float s[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const float e = expf(__fdiv_rn(pr[p], temp) - m);
    const int y = p / w, x = p - y * w;
    s[0] += e;
    s[1] += e * (2.f * __fdiv_rn((float)x, (float)(w - 1)) - 1.f);
    s[2] += e * (2.f * __fdiv_rn((float)y, (float)(h - 1)) - 1.f);
#pragma unroll
    for (int f = 0; f < 4; ++f) s[3 + f] += e * jm[f * jmap_f + p];
  }
  __syncthreads();  // partial[][0] is read above; reuse the buffer
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    const float v = warp_sum(s[i]);
    if (lane == 0) partial[wid][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float t = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) t += partial[i][threadIdx.x];
    partial[0][threadIdx.x] = t;  // each thread owns its own column
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float inv = 1.f / partial[0][0];
    value[2 * row] = partial[0][1] * inv;
    value[2 * row + 1] = partial[0][2] * inv;
#pragma unroll
    for (int f = 0; f < 4; ++f) jac[4 * row + f] = partial[0][3 + f] * inv;
  }
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

extern "C" const char* eamm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
