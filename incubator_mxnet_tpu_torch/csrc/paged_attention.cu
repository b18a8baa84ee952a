// Single-query paged attention over the serving KV pool, for sm_90a.
//
// Replaces the Pallas TPU kernel `_paged_kernel`, both as `_paged_core`
// launches it (float pages) and as `_paged_core_q8` does (int8 pages with an
// f32 scale per (block, head, slot); incubator_mxnet_tpu/ops/
// paged_attention.py).  One template covers both page types.  One thread
// block per (lane, head) walks pages 0 .. pos/bs of its lane, reading each
// page id from the lane's block-table row itself (the TPU's scalar prefetch
// has no counterpart here).  Per page: stage the K page in shared memory as
// f32 (an int8 page is dequantized row by row on the way in, each slot times
// its scale, as the TPU kernel's `_dequant` does), score every slot
// (dequantize, then dot(k, q), then / sqrt(D), in f32; masked slots at
// -FLT_MAX), update the running (m, l, acc) online softmax, stage the V page
// in the same buffer and accumulate p.V.  Output acc / l, once.
//
// Bound on the H100: bytes.  A decode step reads every live page of every
// lane once (2 * pages * bs * D * sizeof(T) per head) and does ~4 flops
// per byte, far below the card's ~295 flop/byte ridge.  This first design
// keeps each byte read exactly once (no dense gather, nothing
// (B, H, max_seq_len)-shaped in device memory) and skips pages past pos;
// it does not yet overlap the page loads with the math (cp.async / TMA
// double buffering is later work).  int8 pages halve the page bytes: a live
// (page, head) costs 2 * bs * (D + 4) bytes with its scales, against
// 2 * bs * D * 2 for bf16 pages; while the serial page walk keeps the
// kernel latency-bound, that buys capacity more than time.
//
// The eviction contract of the serving engine holds inside this kernel:
// a block touches only its own lane's table row, pages and output; masked
// slots are skipped (they contribute exactly 0.0; their content and, for
// int8 pages, their scales are not even loaded: the staging writes 0.0 for
// them, so garbage or NaN there never reaches a sum); there are no atomics
// and every sum runs in a fixed order, so the same inputs give bitwise-equal
// output whichever other lanes share the batch.
#include <cfloat>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBs = 64;
constexpr int kMaxD = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Stage slot rows of one page into kv_s as f32: row i is live iff
// j * bs + i <= t.  Float pages convert; int8 pages multiply by the slot's
// scale (`_dequant`: f32(page) * scale).  Dead rows get 0.0 and their page
// bytes and scale are never loaded.
template <typename P>
__device__ __forceinline__ void stage_page(float* kv_s,
                                           const P* __restrict__ page,
                                           const float* __restrict__ scale,
                                           int live, int bs, int D, int ld,
                                           int tid) {
  for (int i = tid; i < bs * D; i += kThreads) {
    const int r = i / D;
    float x = 0.f;
    if (r < live) {
      x = to_f32(page[i]);
      if constexpr (std::is_same<P, int8_t>::value) x *= scale[r];
    }
    kv_s[r * ld + i % D] = x;
  }
}

// T: q and output type (f32 or bf16); P: page type (T, or int8 with f32
// scales (num_blocks, H, bs) in scale_k / scale_v, null for float pages).
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const P* __restrict__ pool_k,
                       const P* __restrict__ pool_v,
                       const float* __restrict__ scale_k,
                       const float* __restrict__ scale_v,
                       const int32_t* __restrict__ tables,
                       const int32_t* __restrict__ pos, T* __restrict__ out,
                       int H, int D, int bs, int nbps, float sqrt_d) {
  __shared__ float q_s[kMaxD];
  __shared__ float kv_s[kMaxBs * (kMaxD + 1)];  // one page, row pitch D + 1
  __shared__ float s_s[kMaxBs];
  __shared__ float p_s[kMaxBs];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int ld = D + 1;
  const int t = pos[b];
  const int last = t < 0 ? -1 : min(t / bs, nbps - 1);
  const size_t row = (static_cast<size_t>(b) * H + h) * D;

  for (int d = tid; d < D; d += kThreads) q_s[d] = to_f32(q[row + d]);

  float m = -FLT_MAX;  // running max, finfo(f32).min like the TPU kernel
  float l = 0.f;       // running denominator
  float acc = 0.f;     // thread tid < D owns output column tid
  for (int j = 0; j <= last; ++j) {
    // (block, head) of this page: its slots' first scale, then its values
    const size_t slot0 =
        (static_cast<size_t>(tables[static_cast<size_t>(b) * nbps + j]) * H +
         h) * static_cast<size_t>(bs);
    const size_t page = slot0 * D;
    const int live = min(bs, t - j * bs + 1);  // rows 0 .. live-1 are <= t
    __syncthreads();  // the previous page's readers of kv_s / p_s are done
    stage_page(kv_s, pool_k + page, scale_k ? scale_k + slot0 : nullptr, live,
               bs, D, ld, tid);
    __syncthreads();
    if (tid < bs) {
      float s = -FLT_MAX;
      if (tid < live) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d)
          dot = fmaf(kv_s[tid * ld + d], q_s[d], dot);
        s = dot / sqrt_d;  // scaled after the dot, as the TPU kernel does
      }
      s_s[tid] = s;
    }
    __syncthreads();  // scores ready; nobody reads the K page any more
    float m_new = m;
    for (int i = 0; i < bs; ++i) m_new = fmaxf(m_new, s_s[i]);
    const float alpha = expf(m - m_new);
    if (tid < bs) p_s[tid] = tid < live ? expf(s_s[tid] - m_new) : 0.f;
    stage_page(kv_s, pool_v + page, scale_v ? scale_v + slot0 : nullptr, live,
               bs, D, ld, tid);
    __syncthreads();
    float psum = 0.f;
    for (int i = 0; i < bs; ++i) psum += p_s[i];
    l = alpha * l + psum;
    if (tid < D) {
      float pv = 0.f;
      for (int i = 0; i < live; ++i) pv = fmaf(p_s[i], kv_s[i * ld + tid], pv);
      acc = acc * alpha + pv;
    }
    m = m_new;
  }
  if (tid < D) out[row + tid] = from_f32<T>(l > 0.f ? acc / l : 0.f);
}

template <typename T, typename P>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* scale_k, const void* scale_v, const void* tables,
           const void* pos, void* out, int B, int H, int D, int bs, int nbps,
           cudaStream_t stream) {
  dim3 grid(B, H);
  paged_attention_kernel<T, P><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pool_k),
      static_cast<const P*>(pool_v), static_cast<const float*>(scale_k),
      static_cast<const float*>(scale_v), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(pos), static_cast<T*>(out), H, D, bs, nbps,
      sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, out (B, H, D); pools
// (num_blocks, H, bs, D) in q's dtype; tables (B, nbps) int32; pos (B,)
// int32; all contiguous on one device.  D <= 128, bs <= 64 (the wrapper
// checks).  Returns cudaGetLastError() after the launch.
extern "C" int mx_paged_attention(int dtype, const void* q, const void* pool_k,
                                  const void* pool_v, const void* tables,
                                  const void* pos, void* out, int B, int H,
                                  int D, int bs, int nbps, void* stream) {
  if (D > kMaxD || bs > kMaxBs) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(q, pool_k, pool_v, nullptr, nullptr, tables,
                                pos, out, B, H, D, bs, nbps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, pool_k, pool_v, nullptr,
                                                nullptr, tables, pos, out, B,
                                                H, D, bs, nbps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8-page variant: pools (num_blocks, H, bs, D) int8, scale_k and
// scale_v (num_blocks, H, bs) float32; q and out f32 (dtype 0) or bf16
// (dtype 1); the rest as mx_paged_attention.
extern "C" int mx_paged_attention_q8(int dtype, const void* q,
                                     const void* pool_k, const void* pool_v,
                                     const void* scale_k, const void* scale_v,
                                     const void* tables, const void* pos,
                                     void* out, int B, int H, int D, int bs,
                                     int nbps, void* stream) {
  if (D > kMaxD || bs > kMaxBs || scale_k == nullptr || scale_v == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, int8_t>(q, pool_k, pool_v, scale_k, scale_v, tables,
                                 pos, out, B, H, D, bs, nbps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t>(q, pool_k, pool_v, scale_k, scale_v,
                                         tables, pos, out, B, H, D, bs, nbps,
                                         s);
  return static_cast<int>(cudaErrorInvalidValue);
}
