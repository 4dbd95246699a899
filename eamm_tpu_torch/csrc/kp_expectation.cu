// Keypoint expectation for NVIDIA Hopper: forward, backward and fused.
//
// Replaces the TPU kernels
//   kp_expectation       <- eamm_tpu/ops/kp_expectation.py: kp_expectation ->
//                           _pallas_impl -> _kernel (the forward);
//   kp_expectation_backward (K3b) <- the same file's custom_vjp backward
//                           (_bwd, the autodiff of _xla_impl; it has no
//                           Pallas kernel), section below K5;
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
// 172 MB).  Both read each input byte from device memory once, coalesced
// along the row, in place through the strides, so a conv output
// [B, K + 4K, h, w] feeds pred = y[:, :K] and jmap = y[:, K:] uncopied; no
// padding.  kp_expectation is one block per row: a max pass pulls the row
// into L1/L2 and the sums pass reads it there.  kp_expectation_fused is
// designed for the card's memory system (below its section's head): one
// pass per row with every plane's loads in flight at once, and K3b takes
// the same design (its section's head).  The TPU
// kernel's -1e9 lane and row padding is TPU layout and has no counterpart
// here.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
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

// The block's sums of s[0..N), N <= kSums, left in s on every thread; the
// warps' partial sums are added in warp order, so the result does not
// depend on scheduling.
template <int N>
__device__ __forceinline__ void block_sums(float (&s)[N],
                                           float (*partial)[kSums]) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float v = warp_sum(s[i]);
    if (lane == 0) partial[wid][i] = v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
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

// ---------------------------------------------------------------- K5
//
// kp_expectation_fused, designed for the card's memory system.  Persistent
// blocks (as many as the card holds at once) each walk rows, so there is
// no wave tail.  A row goes in ONE pass over its five planes: each step,
// a thread loads a group of 4 pixels from all five planes at once as 16-
// or 8-byte streaming vectors (80 bytes a thread in float32, 20 KB a
// block, 4 blocks an SM), with no barrier between the max and the sums.
// That needs the max before it is known: each thread keeps a running
// softmax (its largest logit m and the sums of exp(l - m), rescaled when
// m rises), and the block combines the threads' sums against the row's
// max.  (Two groups a thread, or the next row's first loads issued before
// this row's barriers, were no faster: at 4 blocks an SM the registers
// spill.  Staging the planes in shared memory instead, by 16-byte
// cp.async into a ring of chunks issued ahead across row ends, was 1.2 to
// 4.4 times slower on an H100: each chunk costs a barrier and a pass
// through shared memory, and the ring cuts the blocks an SM holds.)  The
// launch, blocks and shared memory, is ops/kp_expectation.py fused_plan's.
// The grid coordinates come from per-block tables with a (y, x) walk and
// no division per pixel.  With the heatmap, the row's logits stay in
// shared memory and the heatmap is written from there in 16- or
// 8-byte vectors.  Pixels before the first aligned group and after the
// last one, or every pixel of a row whose five planes are not aligned
// alike, go one at a time.

constexpr int kGroup = 4;           // pixels per vector access
constexpr int kFusedMinBlocks = 4;  // blocks per SM the registers must allow
constexpr int kMaxSmem = 232448;    // a block's opt-in maximum on sm_90
constexpr int kFusedStaticSmem = (kWarps + kWarps * kSums) * (int)sizeof(float);
constexpr int kFusedSmemBudget = kMaxSmem - kFusedStaticSmem;

// kGroup values of T in one access, as loaded
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<__nv_bfloat16> { using type = uint2; };

// kGroup values at an address aligned to kGroup values; the inputs are
// read once and the heatmap written once (evict first)
template <typename T>
__device__ __forceinline__ typename Vec<T>::type load_group(const T* p) {
  return __ldcs(reinterpret_cast<const typename Vec<T>::type*>(p));
}
__device__ __forceinline__ void unpack(float4 q, float (&v)[kGroup]) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void unpack(uint2 q, float (&v)[kGroup]) {
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void store_group(float* p, const float (&v)[kGroup]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ void store_group(__nv_bfloat16* p,
                                            const float (&v)[kGroup]) {
  __stcs(reinterpret_cast<uint2*>(p),
         make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3])));
}

// The pixels before the first one at an address aligned for a group.
template <typename T>
__device__ __forceinline__ int group_head(const T* p) {
  const unsigned long long i = reinterpret_cast<unsigned long long>(p) / sizeof(T);
  return (int)((kGroup - i % kGroup) % kGroup);
}

// Pixel i of an n-pixel axis, 2 i / (n - 1) - 1, as K3 computes it, from
// the block's table where there is one.
__device__ __forceinline__ float axis_coord(int i, int n) {
  return 2.f * __fdiv_rn((float)i, (float)(n - 1)) - 1.f;
}
__device__ __forceinline__ float coord(const float* table, int i, int n) {
  return table != nullptr ? table[i] : axis_coord(i, n);
}

// A running softmax over the pixels one thread has seen: m, the largest
// logit so far (-FLT_MAX before any, so that a -inf logit adds 0), and
// the sums of e = exp(l - m) times 1, gx, gy and the four maps, rescaled
// whenever m rises.
struct Online {
  float m = -FLT_MAX;
  float s[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  __device__ __forceinline__ void raise(float top) {
    if (top > m) {
      const float f = expf(m - top);
#pragma unroll
      for (int i = 0; i < kSums; ++i) s[i] *= f;
      m = top;
    }
  }
  __device__ __forceinline__ void add(float l, float gx, float gy, float j0,
                                      float j1, float j2, float j3) {
    const float e = expf(l - m);
    s[0] += e;
    s[1] += e * gx;
    s[2] += e * gy;
    s[3] += e * j0;
    s[4] += e * j1;
    s[5] += e * j2;
    s[6] += e * j3;
  }
};

// heat: [B*K, P] contiguous in the prediction's type, or null.  Dynamic
// shared memory: the row's P logits when heat is wanted, then, with
// `tables`, gx[w] and gy[h].
template <typename TP, typename TJ>
__global__ void __launch_bounds__(kThreads, kFusedMinBlocks)
kp_expectation_fused_kernel(
    const TP* __restrict__ pred, long long pred_b, long long pred_k,
    const TJ* __restrict__ jmap, long long jmap_b, long long jmap_k,
    long long jmap_f, float* __restrict__ value, float* __restrict__ jac,
    TP* __restrict__ heat, int rows, int K, int h, int w, float temp,
    bool tables) {
  extern __shared__ float smem[];
  __shared__ float scratch[kWarps];
  __shared__ float partial[kWarps][kSums];
  const int P = h * w;
  float* const logits = smem;
  float* const gx = tables ? smem + (heat != nullptr ? P : 0) : nullptr;
  float* const gy = tables ? gx + w : nullptr;
  if (tables) {
    for (int i = threadIdx.x; i < w; i += kThreads) gx[i] = axis_coord(i, w);
    for (int i = threadIdx.x; i < h; i += kThreads) gy[i] = axis_coord(i, h);
    __syncthreads();
  }
  // p / w == __umulhi(p, magic) for p * w < 2^32
  const unsigned magic = 0xffffffffu / (unsigned)w + 1u;

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int b = row / K, k = row - b * K;
    const TP* pr = pred + b * pred_b + k * pred_k;
    const TJ* jm = jmap + b * jmap_b + k * jmap_k;
    // one head for all five planes, else every pixel goes one at a time
    const int head = group_head(pr);
    bool grouped = head < P;
#pragma unroll
    for (int f = 0; f < 4; ++f)
      grouped = grouped && group_head(jm + f * jmap_f) == head;
    const int first = grouped ? head : P;
    const int groups = (P - first) / kGroup;
    const int after = first + groups * kGroup;  // the first pixel past them

    Online acc;
    for (int g = threadIdx.x; g < groups; g += kThreads) {
      const int p0 = first + g * kGroup;
      float l[kGroup], j[4][kGroup];
      unpack(load_group(pr + p0), l);
#pragma unroll
      for (int f = 0; f < 4; ++f) unpack(load_group(jm + f * jmap_f + p0), j[f]);
      float top = -FLT_MAX;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        l[i] = __fdiv_rn(l[i], temp);
        top = fmaxf(top, l[i]);
      }
      if (heat != nullptr) {
#pragma unroll
        for (int i = 0; i < kGroup; ++i) logits[p0 + i] = l[i];
      }
      acc.raise(top);
      int y = (int)__umulhi((unsigned)p0, magic), x = p0 - y * w;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        acc.add(l[i], coord(gx, x, w), coord(gy, y, h), j[0][i], j[1][i],
                j[2][i], j[3][i]);
        if (++x == w) {
          x = 0;
          ++y;
        }
      }
    }
    const int loose = first + P - after;
    for (int q = threadIdx.x; q < loose; q += kThreads) {
      const int p = q < first ? q : after + q - first;
      const float l = __fdiv_rn(to_float(pr[p]), temp);
      if (heat != nullptr) logits[p] = l;
      const int y = (int)__umulhi((unsigned)p, magic), x = p - y * w;
      acc.raise(l);
      acc.add(l, coord(gx, x, w), coord(gy, y, h), to_float(jm[p]),
              to_float(jm[jmap_f + p]), to_float(jm[2 * jmap_f + p]),
              to_float(jm[3 * jmap_f + p]));
    }

    // the threads' sums against the row's max, added in warp order
    const float m = block_max(acc.m, scratch);
    const float f = expf(acc.m - m);
#pragma unroll
    for (int i = 0; i < kSums; ++i) acc.s[i] *= f;
    block_sums(acc.s, partial);
    store_row(acc.s, row, value, jac);

    if (heat != nullptr) {
      const float inv = 1.f / acc.s[0];
      TP* hr = heat + (long long)row * P;
      const int hfirst = min(group_head(hr), P);
      const int hgroups = (P - hfirst) / kGroup;
      const int hafter = hfirst + hgroups * kGroup;
      for (int g = threadIdx.x; g < hgroups; g += kThreads) {
        const int p0 = hfirst + g * kGroup;
        float v[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) v[i] = expf(logits[p0 + i] - m) * inv;
        store_group(hr + p0, v);
      }
      const int hloose = hfirst + P - hafter;
      for (int q = threadIdx.x; q < hloose; q += kThreads) {
        const int p = q < hfirst ? q : hafter + q - hfirst;
        from_float(hr + p, expf(logits[p] - m) * inv);
      }
      __syncthreads();  // every read of the logits before the next row's writes
    }
  }
}

// ---------------------------------------------------------------- K3b
//
// The backward of kp_expectation.  Given g_value [B,K,2] and g_jac
// [B,K,2,2] (contiguous), per (b, k) row:
//   p         = softmax(pred / T), recomputed from pred (the forward saves
//               only pred and jmap, as the custom_vjp does)
//   s         = g_value . (gx, gy) + sum_f g_jac[f] * jmap[f]
//   grad_pred = p * (s - sum p*s) / T
//   grad_jmap[f] = p * g_jac[f]
// with the coordinates generated here, as the forward does.  It reads 5
// floats a pixel and writes 5, so it is bound by its bytes: 129 MB at
// [96,10,58,58], 0.0386 ms at 3.35 TB/s.  Its first design, one block a
// row in three passes (max, the sums, the outputs) that read pred three
// times and jmap twice by scalar loads, each pass recomputing the logit,
// exp and a division per pixel, took 0.0978 ms on an H100 (39%).
//
// This design is K5's: persistent blocks walk the rows (the launch is
// ops/kp_expectation.py backward_plan's) and each row is read from device
// memory in ONE pass, a thread loading groups of 4 pixels from all five
// planes at once as 16-byte streaming vectors.  What the outputs need of
// a pixel, its logit and s, stays on the chip: in registers, G groups a
// thread (G = 1, 2 or 4: rows of up to 4096 pixels at 256 threads), or
// for a larger row in shared memory (8 bytes a pixel).  Then the row's
// max (one barrier), one exp a pixel and the two sums (one barrier), and
// the outputs from registers as 16-byte streaming stores.  The
// coordinates come from per-block tables, with no division per pixel.  A
// row whose ten planes (five read, five written) do not start alike
// against 16 bytes (a row of h*w pixels that is no multiple of 4, or
// planes off 16 bytes) goes one pixel at a time, pixel (4 g + i) * 256 + t
// in thread t's slot (g, i), so that a warp's loads are still coalesced;
// the pixels before the first aligned group and after the last, at most
// six, go one to a thread.  On an H100 it takes 0.054 ms at [96,10,58,58]
// (71% of its bound), 0.057 at part2's map_4 [256,4,58,58] (72%).

// Slot (g, i) of thread t holds pixel first + (t + g * kThreads) * kGroup
// + i while t + g * kThreads < groups in a grouped row, else pixel
// (g * kGroup + i) * kThreads + t while it is before `after`; thread
// t < loose holds one more.
struct RowSlots {
  int first, groups, after, loose;
  bool grouped;
};

__device__ __forceinline__ RowSlots row_slots(const float* pr,
                                              const float* jm,
                                              long long jmap_f,
                                              const float* gp,
                                              const float* gjm, int P) {
  RowSlots r;
  const int head = group_head(pr);
  r.grouped = head < P && group_head(gp) == head;
#pragma unroll
  for (int f = 0; f < 4; ++f)
    r.grouped = r.grouped && group_head(jm + f * jmap_f) == head &&
                group_head(gjm + (long long)f * P) == head;
  r.first = r.grouped ? head : 0;
  r.groups = (P - r.first) / kGroup;
  r.after = r.first + r.groups * kGroup;
  r.loose = r.first + P - r.after;
  return r;
}

// G > 0: the row's logits and s in registers, G groups a thread; G == 0:
// in dynamic shared memory, logits [P] then s [P], before the tables.
template <int G>
__global__ void __launch_bounds__(kThreads, 3)
kp_expectation_backward_kernel(
    const float* __restrict__ pred, long long pred_b, long long pred_k,
    const float* __restrict__ jmap, long long jmap_b, long long jmap_k,
    long long jmap_f, const float* __restrict__ g_value,
    const float* __restrict__ g_jac, float* __restrict__ grad_pred,
    float* __restrict__ grad_jmap, int rows, int K, int h, int w,
    float temp, bool tables) {
  extern __shared__ float smem[];
  __shared__ float scratch[kWarps];
  __shared__ float partial[kWarps][kSums];
  const int P = h * w;
  const int t = threadIdx.x;
  float* const held = smem;
  float* const gx = tables ? smem + (G == 0 ? 2 * P : 0) : nullptr;
  float* const gy = tables ? gx + w : nullptr;
  if (tables) {
    for (int i = t; i < w; i += kThreads) gx[i] = axis_coord(i, w);
    for (int i = t; i < h; i += kThreads) gy[i] = axis_coord(i, h);
    __syncthreads();
  }
  // p / w == __umulhi(p, magic) for p * w < 2^32
  const unsigned magic = 0xffffffffu / (unsigned)w + 1u;

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int b = row / K, k = row - b * K;
    const float* pr = pred + b * pred_b + k * pred_k;
    const float* jm = jmap + b * jmap_b + k * jmap_k;
    float* gp = grad_pred + (long long)row * P;
    float* gjm = grad_jmap + (long long)row * 4 * P;
    const float gv0 = g_value[2 * row], gv1 = g_value[2 * row + 1];
    float gj[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) gj[f] = g_jac[4 * row + f];
    const RowSlots rs = row_slots(pr, jm, jmap_f, gp, gjm, P);
    auto s_at = [&](int x, int y, const float (&j)[4]) {
      float v = gv0 * coord(gx, x, w) + gv1 * coord(gy, y, h);
#pragma unroll
      for (int f = 0; f < 4; ++f) v = fmaf(gj[f], j[f], v);
      return v;
    };
    // pixel p's logit and s, read from the five planes
    auto read_one = [&](int p, float& l, float& sv) {
      const int y = (int)__umulhi((unsigned)p, magic), x = p - y * w;
      float j[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) j[f] = __ldcs(jm + f * jmap_f + p);
      l = __fdiv_rn(__ldcs(pr + p), temp);
      sv = s_at(x, y, j);
    };
    // a vector group's four logits and s
    auto read_group = [&](int p0, float (&l)[kGroup], float (&sv)[kGroup]) {
      float v[kGroup], j[4][kGroup];
      unpack(load_group(pr + p0), v);
#pragma unroll
      for (int f = 0; f < 4; ++f) unpack(load_group(jm + f * jmap_f + p0), j[f]);
      int y = (int)__umulhi((unsigned)p0, magic), x = p0 - y * w;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        l[i] = __fdiv_rn(v[i], temp);
        const float ji[4] = {j[0][i], j[1][i], j[2][i], j[3][i]};
        sv[i] = s_at(x, y, ji);
        if (++x == w) {
          x = 0;
          ++y;
        }
      }
    };
    // a vector group's outputs from its probabilities and s
    auto write_group = [&](int p0, const float (&prob)[kGroup],
                           const float (&sv)[kGroup], float mean_s) {
      float o[kGroup], oj[4][kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        o[i] = __fdiv_rn(prob[i] * (sv[i] - mean_s), temp);
#pragma unroll
        for (int f = 0; f < 4; ++f) oj[f][i] = prob[i] * gj[f];
      }
      store_group(gp + p0, o);
#pragma unroll
      for (int f = 0; f < 4; ++f) store_group(gjm + (long long)f * P + p0, oj[f]);
    };
    auto write_one = [&](int p, float prob, float sv, float mean_s) {
      __stcs(gp + p, __fdiv_rn(prob * (sv - mean_s), temp));
#pragma unroll
      for (int f = 0; f < 4; ++f) __stcs(gjm + (long long)f * P + p, prob * gj[f]);
    };

    float m = -FLT_MAX;
    const int lone = t < rs.loose ? (t < rs.first ? t : rs.after + t - rs.first)
                                  : -1;
    float lone_l = -FLT_MAX, lone_s = 0.f;
    if (lone >= 0) {
      read_one(lone, lone_l, lone_s);
      m = lone_l;
    }
    float sums[2] = {0.f, 0.f};  // sum e, sum e * s
    if constexpr (G > 0) {
      // slot (g, i): of a vector group, or pixel (4 g + i) * kThreads + t
      auto pixel = [&](int g, int i) {
        return rs.grouped ? rs.first + (t + g * kThreads) * kGroup + i
                          : (g * kGroup + i) * kThreads + t;
      };
      auto in_slot = [&](int g, int i) {
        return rs.grouped ? t + g * kThreads < rs.groups
                          : (g * kGroup + i) * kThreads + t < rs.after;
      };
      float l[G][kGroup], sv[G][kGroup];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (rs.grouped) {
          if (in_slot(g, 0)) read_group(pixel(g, 0), l[g], sv[g]);
        } else {
#pragma unroll
          for (int i = 0; i < kGroup; ++i)
            if (in_slot(g, i)) read_one(pixel(g, i), l[g][i], sv[g][i]);
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          if (in_slot(g, i)) m = fmaxf(m, l[g][i]);
      }
      m = block_max(m, scratch);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (in_slot(g, i)) {
            l[g][i] = expf(l[g][i] - m);
            sums[0] += l[g][i];
            sums[1] = fmaf(l[g][i], sv[g][i], sums[1]);
          }
        }
      }
      if (lone >= 0) {
        lone_l = expf(lone_l - m);
        sums[0] += lone_l;
        sums[1] = fmaf(lone_l, lone_s, sums[1]);
      }
      block_sums(sums, partial);
      const float inv = 1.f / sums[0];
      const float mean_s = sums[1] * inv;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (rs.grouped) {
          if (in_slot(g, 0)) {
            float prob[kGroup];
#pragma unroll
            for (int i = 0; i < kGroup; ++i) prob[i] = l[g][i] * inv;
            write_group(pixel(g, 0), prob, sv[g], mean_s);
          }
        } else {
#pragma unroll
          for (int i = 0; i < kGroup; ++i)
            if (in_slot(g, i))
              write_one(pixel(g, i), l[g][i] * inv, sv[g][i], mean_s);
        }
      }
      if (lone >= 0) write_one(lone, lone_l * inv, lone_s, mean_s);
    } else {
      // groups q = t, t + kThreads, ... of vectors, or pixels t,
      // t + kThreads, ... before rs.after one at a time
      const int step = rs.grouped ? kGroup : 1;
      const int n = rs.grouped ? rs.groups : rs.after;
      float* const hl = held;      // logits, then e
      float* const hs = held + P;  // s
      for (int q = t; q < n; q += kThreads) {
        const int p0 = rs.first + q * step;
        float l[kGroup], sv[kGroup];
        if (rs.grouped) read_group(p0, l, sv);
        else read_one(p0, l[0], sv[0]);
        for (int i = 0; i < step; ++i) {
          hl[p0 + i] = l[i];
          hs[p0 + i] = sv[i];
          m = fmaxf(m, l[i]);
        }
      }
      m = block_max(m, scratch);
      for (int q = t; q < n; q += kThreads) {
        const int p0 = rs.first + q * step;
        for (int i = 0; i < step; ++i) {
          const float e = expf(hl[p0 + i] - m);
          hl[p0 + i] = e;
          sums[0] += e;
          sums[1] = fmaf(e, hs[p0 + i], sums[1]);
        }
      }
      if (lone >= 0) {
        lone_l = expf(lone_l - m);
        sums[0] += lone_l;
        sums[1] = fmaf(lone_l, lone_s, sums[1]);
      }
      block_sums(sums, partial);
      const float inv = 1.f / sums[0];
      const float mean_s = sums[1] * inv;
      for (int q = t; q < n; q += kThreads) {
        const int p0 = rs.first + q * step;
        if (rs.grouped) {
          float prob[kGroup], sv[kGroup];
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            prob[i] = hl[p0 + i] * inv;
            sv[i] = hs[p0 + i];
          }
          write_group(p0, prob, sv, mean_s);
        } else {
          write_one(p0, hl[p0] * inv, hs[p0], mean_s);
        }
      }
      if (lone >= 0) write_one(lone, lone_l * inv, lone_s, mean_s);
      __syncthreads();  // the next row's slots may be another thread's
    }
  }
}

// The arguments of eamm_kp_expectation_fused and
// eamm_kp_expectation_fused_resident.
struct FusedArgs {
  const void* pred;
  long long pred_b, pred_k;
  const void* jmap;
  long long jmap_b, jmap_k, jmap_f;
  void *value, *jac, *heat;
  int B, K, h, w;
  float temp;
  int smem, tables, blocks;
  cudaStream_t stream;
};

struct LaunchFused {
  template <typename TP, typename TJ>
  static int run(const FusedArgs& a, int*) {
    if (a.smem < 0 || a.smem > kFusedSmemBudget || a.blocks < 1)
      return (int)cudaErrorInvalidValue;
    kp_expectation_fused_kernel<TP, TJ><<<a.blocks, kThreads, a.smem,
                                          a.stream>>>(
        static_cast<const TP*>(a.pred), a.pred_b, a.pred_k,
        static_cast<const TJ*>(a.jmap), a.jmap_b, a.jmap_k, a.jmap_f,
        static_cast<float*>(a.value), static_cast<float*>(a.jac),
        static_cast<TP*>(a.heat), a.B * a.K, a.K, a.h, a.w, a.temp,
        a.tables != 0);
    return (int)cudaGetLastError();
  }
};

// The blocks the card holds at once with a.smem bytes of dynamic shared
// memory each, into *out; lets the kernel take up to kFusedSmemBudget.
struct ResidentFused {
  template <typename TP, typename TJ>
  static int run(const FusedArgs& a, int* out) {
    auto kernel = kp_expectation_fused_kernel<TP, TJ>;
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kFusedSmemBudget)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, a.smem)) != cudaSuccess)
      return (int)err;
    *out = sms * per_sm;
    return 0;
  }
};

// Op::run<TP, TJ> for pdtype and jdtype (0 float32, 1 bfloat16).
template <typename Op>
int by_dtype(int pdtype, int jdtype, const FusedArgs& a, int* out) {
  if (pdtype == 0 && jdtype == 0) return Op::template run<float, float>(a, out);
  if (pdtype == 0 && jdtype == 1)
    return Op::template run<float, __nv_bfloat16>(a, out);
  if (pdtype == 1 && jdtype == 0)
    return Op::template run<__nv_bfloat16, float>(a, out);
  if (pdtype == 1 && jdtype == 1)
    return Op::template run<__nv_bfloat16, __nv_bfloat16>(a, out);
  return (int)cudaErrorInvalidValue;
}

// K3b's kernel for G groups a thread (0: shared memory).
using BackwardKernel = void (*)(const float*, long long, long long,
                                const float*, long long, long long, long long,
                                const float*, const float*, float*, float*,
                                int, int, int, int, float, bool);

BackwardKernel backward_kernel(int groups) {
  switch (groups) {
    case 0: return kp_expectation_backward_kernel<0>;
    case 1: return kp_expectation_backward_kernel<1>;
    case 2: return kp_expectation_backward_kernel<2>;
    case 4: return kp_expectation_backward_kernel<4>;
    default: return nullptr;
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

// As eamm_kp_expectation, with pdtype and jdtype (0 float32, 1 bfloat16) for
// pred and jmap, and heat: null, or [B*K*h*w] in pred's type for the
// normalized heatmap.  The launch as ops/kp_expectation.py fused_plan
// makes it: blocks persistent blocks of smem bytes of dynamic shared memory
// (the row's float32 logits when heat is wanted, then, if tables, gx[w] and
// gy[h]); eamm_kp_expectation_fused_resident at that size must have been
// called first on this device.
extern "C" int eamm_kp_expectation_fused(
    const void* pred, int pdtype, long long pred_b, long long pred_k,
    const void* jmap, int jdtype, long long jmap_b, long long jmap_k,
    long long jmap_f, void* value, void* jac, void* heat, int B, int K, int h,
    int w, float temp, int smem, int tables, int blocks, void* stream) {
  cudaGetLastError();  // clear any earlier error of this runtime
  const FusedArgs a{pred,  pred_b, pred_k, jmap,   jmap_b, jmap_k,
                    jmap_f, value, jac,    heat,   B,      K,
                    h,     w,      temp,   smem,   tables, blocks,
                    static_cast<cudaStream_t>(stream)};
  return by_dtype<LaunchFused>(pdtype, jdtype, a, nullptr);
}

// The fused kernel's blocks that the current device holds at once with
// smem bytes of dynamic shared memory each, for pdtype and jdtype, into
// *resident.  Returns a cudaError_t.
extern "C" int eamm_kp_expectation_fused_resident(int pdtype, int jdtype,
                                                  int smem, int* resident) {
  FusedArgs a{};
  a.smem = smem;
  return by_dtype<ResidentFused>(pdtype, jdtype, a, resident);
}

// K3b: g_value [B,K,2] and g_jac [B,K,2,2] contiguous float32 -> grad_pred
// [B,K,h,w] and grad_jmap [B,K,4,h,w], contiguous float32; pred and jmap as
// the forward reads them.  The launch as ops/kp_expectation.py
// backward_plan makes it: blocks persistent blocks holding `groups`
// groups of 4 pixels a thread in registers (1, 2 or 4), or 0 for the
// shared-memory path, with smem bytes of dynamic shared memory (with
// groups 0 the row's logits and s, 8 bytes a pixel, then, if tables,
// gx[w] and gy[h]); eamm_kp_expectation_backward_resident at that plan
// must have been called first on this device.
extern "C" int eamm_kp_expectation_backward(
    const void* pred, long long pred_b, long long pred_k, const void* jmap,
    long long jmap_b, long long jmap_k, long long jmap_f, const void* g_value,
    const void* g_jac, void* grad_pred, void* grad_jmap, int B, int K, int h,
    int w, float temp, int groups, int smem, int tables, int blocks,
    void* stream) {
  cudaGetLastError();  // clear any earlier error of this runtime
  const BackwardKernel kernel = backward_kernel(groups);
  if (kernel == nullptr || smem < 0 || smem > kFusedSmemBudget || blocks < 1)
    return (int)cudaErrorInvalidValue;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pred), pred_b, pred_k,
      static_cast<const float*>(jmap), jmap_b, jmap_k, jmap_f,
      static_cast<const float*>(g_value), static_cast<const float*>(g_jac),
      static_cast<float*>(grad_pred), static_cast<float*>(grad_jmap), B * K,
      K, h, w, temp, tables != 0);
  return (int)cudaGetLastError();
}

// K3b's blocks that the current device holds at once for `groups` with smem
// bytes of dynamic shared memory each, into *resident; lets the kernel
// take up to kFusedSmemBudget.  Returns a cudaError_t.
extern "C" int eamm_kp_expectation_backward_resident(int groups, int smem,
                                                     int* resident) {
  const BackwardKernel kernel = backward_kernel(groups);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           kFusedSmemBudget)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  *resident = sms * per_sm;
  return 0;
}

extern "C" const char* eamm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
