// Streamed softmax cross-entropy over a wide vocabulary, for sm_90a.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (launched by `_pallas_fwd`)
// and `_bwd_kernel` (launched by `_pallas_bwd`) of
// incubator_mxnet_tpu/ops/xent_kernel.py.  As there, no (N, V) f32 tensor
// ever exists: the forward reads the logits once and writes only the f32
// row logsumexp (plus the raw row sum for the label-smoothed loss), and the
// backward regenerates softmax from the saved lse and writes d(logits) in
// the logits' dtype.  The O(N) label gather and the loss value stay torch
// ops around the forward.
//
// Forward: one thread block per row.  The TPU kernel walked vocabulary
// blocks in grid order, carrying (m, l) in scratch; here the block's threads
// stride over the row with an f32 online max/sum each, then merge the
// per-thread (m, l, sum) by a fixed xor-butterfly inside each warp and warp
// 0 over the warps in index order, so the result is deterministic.  Rows
// are only 4-byte aligned when V is even but not a multiple of 8 (bf16
// V = 30522: a row stride of 61,044 bytes), so each row is read as a
// scalar head up to the first 16-byte boundary, 16-byte vectors, and a
// scalar tail.  The `m_old == -inf` guard of the TPU kernel is kept
// wherever two partial maxima meet, so rows of extreme or -inf logits
// stay finite where the math is.
//
// Backward: a 2-D grid over (row, vocabulary chunk); each element gets
// (exp(x - lse[row]) - ((1 - eps) * [col == label] + eps / V)) * g[row] in
// f32, the label compared in the kernel, written in x's dtype.
//
// Bound on the H100: bytes.  The forward reads N*V elements once (~1 exp
// per element), the backward reads and writes them once; both are far below
// the card's flop/byte ridge.  The forward's vector loads serve that bound;
// the backward's loads and stores are scalar and coalesced (vectorising it
// is later work).
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBwdPerThread = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Running (max, sum of exp(x - max), raw sum) of one thread or one merge.
struct Stats {
  float m;
  float l;
  float s;
};

__device__ __forceinline__ Stats merge(Stats a, Stats b) {
  const float m = fmaxf(a.m, b.m);
  Stats r{m, 0.f, a.s + b.s};
  if (m != -INFINITY) {
    r.l = (a.m == -INFINITY ? 0.f : a.l * __expf(a.m - m)) +
          (b.m == -INFINITY ? 0.f : b.l * __expf(b.m - m));
  }
  return r;
}

// Fold n values into st: one rescale per chunk, as the TPU kernel per block.
template <int n>
__device__ __forceinline__ void fold(Stats& st, const float (&v)[n]) {
  float cm = v[0];
  float cs = v[0];
#pragma unroll
  for (int i = 1; i < n; ++i) {
    cm = fmaxf(cm, v[i]);
    cs += v[i];
  }
  st.s += cs;
  const float m = fmaxf(st.m, cm);
  if (m == -INFINITY) return;  // nothing but -inf so far
  float add = 0.f;
#pragma unroll
  for (int i = 0; i < n; ++i) add += __expf(v[i] - m);
  st.l = (st.m == -INFINITY ? 0.f : st.l * __expf(st.m - m)) + add;
  st.m = m;
}

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ x, float* __restrict__ lse,
                float* __restrict__ xsum, int V) {
  constexpr int kVec = Vec<T>::n;
  const T* row = x + static_cast<int64_t>(blockIdx.x) * V;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  const int head = min(V, mis ? (16 - mis) / static_cast<int>(sizeof(T)) : 0);
  const int nvec = (V - head) / kVec;
  const int tail = head + nvec * kVec;
  Stats st{-INFINITY, 0.f, 0.f};
  // scalar head and tail: at most kVec - 1 elements each
  if (threadIdx.x < head) {
    const float v[1] = {to_f32(row[threadIdx.x])};
    fold(st, v);
  }
  if (tail + static_cast<int>(threadIdx.x) < V) {
    const float v[1] = {to_f32(row[tail + threadIdx.x])};
    fold(st, v);
  }
  const T* body = row + head;  // 16-byte aligned
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float v[kVec];
    Vec<T>::load(body + static_cast<int64_t>(i) * kVec, v);
    fold(st, v);
  }
  // fixed-order merge: xor butterfly in the warp, then warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stats o{__shfl_xor_sync(0xffffffffu, st.m, off),
            __shfl_xor_sync(0xffffffffu, st.l, off),
            __shfl_xor_sync(0xffffffffu, st.s, off)};
    st = merge(st, o);
  }
  __shared__ Stats part[kWarps];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) part[warp] = st;
  __syncthreads();
  if (threadIdx.x == 0) {
    Stats r = part[0];
    for (int w = 1; w < kWarps; ++w) r = merge(r, part[w]);
    lse[blockIdx.x] = r.l > 0.f ? r.m + logf(r.l) : -INFINITY;
    if (xsum != nullptr) xsum[blockIdx.x] = r.s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ x, const int32_t* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ g,
                T* __restrict__ dx, int V, float eps) {
  const int64_t r = blockIdx.x;
  const float row_lse = lse[r];
  const float row_g = g[r];
  const int label = labels[r];
  const float hit_w = 1.f - eps;
  const float uniform = eps / static_cast<float>(V);
  const int64_t base = r * V;
  const int c0 = blockIdx.y * (kThreads * kBwdPerThread) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kBwdPerThread; ++j) {
    const int c = c0 + j * kThreads;
    if (c < V) {
      const float p = __expf(to_f32(x[base + c]) - row_lse);
      const float target = (c == label ? hit_w : 0.f) + uniform;
      dx[base + c] = from_f32<T>((p - target) * row_g);
    }
  }
}

template <typename T>
int launch_fwd(const void* x, void* lse, void* xsum, long long N, int V,
               cudaStream_t stream) {
  xent_fwd_kernel<T><<<static_cast<unsigned>(N), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(lse),
      static_cast<float*>(xsum), V);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* labels, const void* lse,
               const void* g, void* dx, long long N, int V, float eps,
               cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(N),
                  (V + kThreads * kBwdPerThread - 1) /
                      (kThreads * kBwdPerThread));
  xent_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<T*>(dx), V, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  x: (N, V) contiguous; lse: f32 (N,); xsum: f32
// (N,) or null.  Returns cudaGetLastError() after the launch.
extern "C" int mx_xent_fwd(int dtype, const void* x, void* lse, void* xsum,
                           long long N, int V, void* stream) {
  if (N <= 0) return 0;
  if (N > 0x7fffffffLL || V <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(x, lse, xsum, N, V, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, lse, xsum, N, V, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// labels: int32 (N,); lse, g: f32 (N,); dx: like x.
extern "C" int mx_xent_bwd(int dtype, const void* x, const void* labels,
                           const void* lse, const void* g, void* dx,
                           long long N, int V, float eps, void* stream) {
  if (N <= 0) return 0;
  if (N > 0x7fffffffLL || V <= 0 ||
      (V + kThreads * kBwdPerThread - 1) / (kThreads * kBwdPerThread) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(x, labels, lse, g, dx, N, V, eps, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, labels, lse, g, dx, N, V, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
