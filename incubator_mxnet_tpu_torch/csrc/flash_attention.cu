// Flash attention forward (online softmax) for sm_90a.
//
// Replaces the Pallas TPU kernels `_fa_kernel_resident` and
// `_fa_kernel_streamed` launched by `_flash_core`
// (incubator_mxnet_tpu/ops/flash_attention.py).  The TPU needed two
// variants only because of its VMEM limit; here one kernel streams K/V
// tiles through shared memory at every length.  One thread block owns one
// (batch*head, 64-row query tile): it stages the query tile pre-scaled in
// f32, then walks 64-column K/V tiles, each with the block math of
// `_fwd_block_update` — f32 scores, mask, running (m, l, acc) with the
// fully-masked-row guards — and writes out = acc / max(l, 1e-30) and the
// row logsumexp (-inf and 0 on fully masked rows), as `_emit_out_lse`.
//
// Masking follows the TPU kernel: causal is bottom-right aligned (key j is
// visible to query i iff j - (Tk - Tq) <= i), ragged Tq / Tk tails are
// masked, and K/V tiles wholly past the diagonal are never visited.
//
// Bound on the H100: operations at the prefill shapes (a 64x64 tile does
// 2*64*64*D flops per 2*64*D*sizeof(T) bytes of K/V).  This first design
// runs the two products on the CUDA cores in f32 (256 threads, a 4x4
// score sub-tile and a 4 x D/16 output sub-tile per thread, operands from
// shared memory), so it is held to the f32 SIMT rate, not the tensor-core
// rate; bf16 inputs are widened to f32 on load.  wgmma, TMA and warp
// specialisation are later work.
#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr int kThreads = 256;  // 16 x 16: ty owns rows, tx owns columns
constexpr int kMaxD = 128;
constexpr int kCols = kMaxD / 16;  // output columns per thread at D = 128

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

// m and lse are finite or -inf; this also rejects +inf and NaN
__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) <= FLT_MAX; }

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, 16));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, 16);
  return v;
}

size_t smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) *
         (static_cast<size_t>(kBq) * ld + 2 * static_cast<size_t>(kBk) * ld +
          static_cast<size_t>(kBq) * (kBk + 1));
}

// Rows owned by thread (ty, tx): ty + 16*i, i < 4.  Score columns:
// tx + 16*j, j < 4.  Output columns: tx + 16*c, c < D/16 (rounded up).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Tq, int Tk, int D, int causal,
                 float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;               // kBq x ld, pre-scaled f32 queries
  float* k_s = q_s + kBq * ld;     // kBk x ld
  float* v_s = k_s + kBk * ld;     // kBk x ld
  float* p_s = v_s + kBk * ld;     // kBq x (kBk + 1) probabilities

  const int bh = blockIdx.x;
  const int row0 = blockIdx.y * kBq;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t qbase = static_cast<size_t>(bh) * Tq * D;
  const size_t kbase = static_cast<size_t>(bh) * Tk * D;
  const int shift = Tk - Tq;
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));

  for (int i = tid; i < kBq * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    q_s[r * ld + d] = row0 + r < Tq
        ? to_f32(q[qbase + static_cast<size_t>(row0 + r) * D + d]) * scale
        : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_inf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // causal: tiles whose first column is past the tile's last row's
  // diagonal are fully masked -- stop the walk before them
  int nk = (Tk + kBk - 1) / kBk;
  if (causal) {
    const int lim = row0 + kBq - 1 + shift;
    nk = lim < 0 ? 0 : min(nk, lim / kBk + 1);
  }

  for (int kb = 0; kb < nk; ++kb) {
    const int col0 = kb * kBk;
    __syncthreads();  // previous tile's readers are done (and q_s is ready)
    for (int i = tid; i < kBk * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const bool ok = col0 + r < Tk;
      const size_t g = kbase + static_cast<size_t>(col0 + r) * D + d;
      k_s[r * ld + d] = ok ? to_f32(k[g]) : 0.f;
      v_s[r * ld + d] = ok ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      bool valid[4];
      float mx = neg_inf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + tx + 16 * j;
        valid[j] = col < Tk && (!causal || col <= row + shift);
        if (valid[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = group16_max(mx);
      const float m_new = fmaxf(m[i], mx);
      // fully masked so far: keep exp() away from (-inf) - (-inf)
      const float m_safe = is_finite(m_new) ? m_new : 0.f;
      const float alpha = is_finite(m[i]) ? expf(m[i] - m_safe) : 0.f;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_safe) : 0.f;
        p_s[(ty + 16 * i) * (kBk + 1) + tx + 16 * j] = p;
        ps += p;
      }
      ps = group16_sum(ps);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the probability tile is complete

    for (int kk = 0; kk < kBk; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * (kBk + 1) + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float vv = v_s[kk * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < D)
        out[qbase + static_cast<size_t>(row) * D + col] =
            from_f32<T>(acc[i][c] / denom);
    }
    if (tx == 0)
      lse[static_cast<size_t>(bh) * Tq + row] =
          is_finite(m[i]) ? m[i] + logf(denom) : neg_inf;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BH, int Tq, int Tk, int D, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(BH, (Tq + kBq - 1) / kBq);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(lse),
      Tq, Tk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, out (BH, Tq, D); k, v (BH, Tk, D);
// lse (BH, Tq) float32; all contiguous on one device.  D <= 128 and a
// multiple of 8; Tq >= 1 (the wrapper checks).  Returns cudaGetLastError()
// after the launch.
extern "C" int mx_flash_attention_fwd(int dtype, const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int BH, int Tq, int Tk, int D,
                                      int causal, float scale, void* stream) {
  if (D > kMaxD || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, lse, BH, Tq, Tk, D, causal, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, lse, BH, Tq, Tk, D, causal,
                                 scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
