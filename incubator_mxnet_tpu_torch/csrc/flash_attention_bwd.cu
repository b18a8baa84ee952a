// Flash attention backward (dK/dV and dQ) for sm_90a.
//
// Replaces the Pallas TPU kernels `_fa_dkdv_kernel` and `_fa_dq_kernel`
// launched by `_flash_bwd_core` (incubator_mxnet_tpu/ops/flash_attention.py).
// Both recompute the probabilities from the forward's saved row logsumexp
// and never hold a (Tq, Tk) matrix: for a 64x64 (query, key) tile they form
// S = Q K^T * scale, P = exp(S - lse), dP = dO V^T and
// dS = P * (dP - delta) * scale, with delta = rowsum(dO * O) (minus the lse
// cotangent in the (out, lse) variant), as `_bwd_block_terms` does.
//
// * dK/dV kernel: one thread block per (batch*head, 64-row key tile).  Its K
//   and V tiles stay in shared memory and its dK, dV sums in registers while
//   it walks the query tiles (Q, dO, lse, delta); per tile it adds P^T dO to
//   dV and dS^T Q to dK.
// * dQ kernel: one thread block per (batch*head, 64-row query tile).  Q, dO
//   and the row statistics stay; it walks the key tiles and adds dS K to dQ.
//
// On the TPU the output block was revisited along the grid's inner axis; here
// the walk is a loop inside the block, so each block owns its output tile:
// no atomics, and two launches on the same inputs give the same bits.
//
// Masking follows the TPU kernels: causal is bottom-right aligned (key j is
// visible to query i iff j - (Tk - Tq) <= i), a (query tile, key tile) pair
// with kb*64 > (qb+1)*64 - 1 + (Tk - Tq) is never visited, ragged Tq / Tk
// tails are masked, and a row whose lse is -inf (it sees no key) contributes
// exactly 0: P uses exp(S - (isfinite(lse) ? lse : 0)) only on valid entries.
//
// Bound on the H100: operations.  A (query, key) pair costs 8*D flops in the
// dK/dV kernel and 6*D in the dQ kernel against O(D) bytes per 64-row tile.
// This first design runs the products on the CUDA cores in f32 (256 threads,
// a 4x4 sub-tile of S and dP and a 4 x D/16 sub-tile of the accumulators per
// thread, operands from shared memory), so it is held to the f32 SIMT rate
// and to shared-memory bandwidth, not to the tensor-core rate; bf16 inputs
// are widened to f32 on load.  At D = 128 the dK/dV kernel stages four f32
// 64x129 tiles and two 64x65 tiles (162 KB of dynamic shared memory), so one
// block fits an SM there and two at D = 64.  wgmma, TMA and warp
// specialisation are later work.
#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kB = 64;          // rows of a query tile and of a key tile
constexpr int kThreads = 256;   // 16 x 16: ty owns tile rows, tx columns
constexpr int kMaxD = 128;
constexpr int kCols = kMaxD / 16;   // accumulator columns per thread at D=128
constexpr int kLdT = kB + 1;        // leading dimension of a 64x64 f32 tile

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

// lse is finite or -inf; this also rejects +inf and NaN
__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) <= FLT_MAX; }

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

// Rows [row0, row0 + 64) of a (rows, D) matrix into shared memory as f32
// with leading dimension D + 1; rows past the end are 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int row0, int rows, int D, int tid) {
  const int ld = D + 1;
  for (int i = tid; i < kB * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = row0 + r < rows
        ? to_f32(src[static_cast<size_t>(row0 + r) * D + d]) : 0.f;
  }
}

// The tile's lse (-inf past Tq, which marks those rows invalid) and delta.
__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int row0, int Tq, int tid) {
  if (tid < kB) {
    const bool in = row0 + tid < Tq;
    lse_s[tid] = in ? lse[row0 + tid] : neg_inf();
    delta_s[tid] = in ? delta[row0 + tid] : 0.f;
  }
}

// (P, dS) of one score entry, as `_bwd_block_terms`: zero unless valid.
__device__ __forceinline__ void p_ds(float s, float dp, float lse,
                                     float delta, bool in_range, float scale,
                                     float* p, float* ds) {
  const bool valid = in_range && is_finite(lse);
  const float pv = valid ? expf(s * scale - lse) : 0.f;
  *p = pv;
  *ds = valid ? pv * (dp - delta) * scale : 0.f;
}

size_t dkdv_smem_bytes(int D) {
  return sizeof(float) * (4 * static_cast<size_t>(kB) * (D + 1) +
                          2 * static_cast<size_t>(kB) * kLdT + 2 * kB);
}

size_t dq_smem_bytes(int D) {
  return sizeof(float) * (4 * static_cast<size_t>(kB) * (D + 1) +
                          static_cast<size_t>(kB) * kLdT + 2 * kB);
}

// Thread (ty, tx) owns key rows ty + 16*a (a < 4) of the block's tile: of
// S^T / dP^T it computes query columns tx + 16*b (b < 4), of dK / dV the
// head columns tx + 16*c (c < D/16, rounded up).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int Tq, int Tk, int D, int causal,
                  float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* k_s = smem;                 // kB x ld
  float* v_s = k_s + kB * ld;        // kB x ld
  float* q_s = v_s + kB * ld;        // kB x ld
  float* do_s = q_s + kB * ld;       // kB x ld
  float* pt_s = do_s + kB * ld;      // kB x kLdT: P^T (key row, query col)
  float* dst_s = pt_s + kB * kLdT;   // kB x kLdT: dS^T
  float* lse_s = dst_s + kB * kLdT;  // kB
  float* delta_s = lse_s + kB;       // kB

  const int bh = blockIdx.x;
  const int col0 = blockIdx.y * kB;  // first key of the block's tile
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t qbase = static_cast<size_t>(bh) * Tq * D;
  const size_t kbase = static_cast<size_t>(bh) * Tk * D;
  const size_t rbase = static_cast<size_t>(bh) * Tq;
  const int shift = Tk - Tq;

  stage(k_s, k + kbase, col0, Tk, D, tid);
  stage(v_s, v + kbase, col0, Tk, D, tid);

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  // causal: query tiles whose last row's diagonal lies before this tile's
  // first key see none of it -- start the walk after them
  int qb = 0;
  if (causal) {
    const int x = col0 - shift;
    qb = x > 0 ? x / kB : 0;
  }
  const int nq = (Tq + kB - 1) / kB;
  for (; qb < nq; ++qb) {
    const int row0 = qb * kB;
    __syncthreads();  // the previous tile's readers are done
    stage(q_s, q + qbase, row0, Tq, D, tid);
    stage(do_s, dout + qbase, row0, Tq, D, tid);
    stage_rows(lse_s, delta_s, lse + rbase, delta + rbase, row0, Tq, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        kv[a] = k_s[(ty + 16 * a) * ld + d];
        vv[a] = v_s[(ty + 16 * a) * ld + d];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        qv[b] = q_s[(tx + 16 * b) * ld + d];
        dov[b] = do_s[(tx + 16 * b) * ld + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[a][b] = fmaf(kv[a], qv[b], s[a][b]);
          dp[a][b] = fmaf(vv[a], dov[b], dp[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int col = col0 + ty + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = tx + 16 * b;
        const int row = row0 + r;
        const bool in_range =
            row < Tq && col < Tk && (!causal || col <= row + shift);
        float p, ds;
        p_ds(s[a][b], dp[a][b], lse_s[r], delta_s[r], in_range, scale, &p,
             &ds);
        pt_s[(ty + 16 * a) * kLdT + r] = p;
        dst_s[(ty + 16 * a) * kLdT + r] = ds;
      }
    }
    __syncthreads();  // P^T and dS^T are complete

    for (int i = 0; i < kB; ++i) {
      float pv[4], dsv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pv[a] = pt_s[(ty + 16 * a) * kLdT + i];
        dsv[a] = dst_s[(ty + 16 * a) * kLdT + i];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float dov = do_s[i * ld + col];
          const float qv = q_s[i * ld + col];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc_v[a][c] = fmaf(pv[a], dov, acc_v[a][c]);
            acc_k[a][c] = fmaf(dsv[a], qv, acc_k[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = col0 + ty + 16 * a;
    if (key >= Tk) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        const size_t g = kbase + static_cast<size_t>(key) * D + col;
        dk[g] = from_f32<T>(acc_k[a][c]);
        dv[g] = from_f32<T>(acc_v[a][c]);
      }
    }
  }
}

// Thread (ty, tx) owns query rows ty + 16*a (a < 4) of the block's tile: of
// S / dP it computes key columns tx + 16*b, of dQ the head columns
// tx + 16*c.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Tq,
                int Tk, int D, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;                 // kB x ld
  float* do_s = q_s + kB * ld;       // kB x ld
  float* k_s = do_s + kB * ld;       // kB x ld
  float* v_s = k_s + kB * ld;        // kB x ld
  float* ds_s = v_s + kB * ld;       // kB x kLdT: dS (query row, key col)
  float* lse_s = ds_s + kB * kLdT;   // kB
  float* delta_s = lse_s + kB;       // kB

  const int bh = blockIdx.x;
  const int row0 = blockIdx.y * kB;  // first query of the block's tile
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t qbase = static_cast<size_t>(bh) * Tq * D;
  const size_t kbase = static_cast<size_t>(bh) * Tk * D;
  const size_t rbase = static_cast<size_t>(bh) * Tq;
  const int shift = Tk - Tq;

  stage(q_s, q + qbase, row0, Tq, D, tid);
  stage(do_s, dout + qbase, row0, Tq, D, tid);
  stage_rows(lse_s, delta_s, lse + rbase, delta + rbase, row0, Tq, tid);

  float acc[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;

  // causal: key tiles whose first key is past the tile's last row's
  // diagonal are fully masked -- stop the walk before them
  int nk = (Tk + kB - 1) / kB;
  if (causal) {
    const int lim = row0 + kB - 1 + shift;
    nk = lim < 0 ? 0 : min(nk, lim / kB + 1);
  }
  for (int kb = 0; kb < nk; ++kb) {
    const int col0 = kb * kB;
    __syncthreads();  // the previous tile's readers are done
    stage(k_s, k + kbase, col0, Tk, D, tid);
    stage(v_s, v + kbase, col0, Tk, D, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qv[a] = q_s[(ty + 16 * a) * ld + d];
        dov[a] = do_s[(ty + 16 * a) * ld + d];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        kv[b] = k_s[(tx + 16 * b) * ld + d];
        vv[b] = v_s[(tx + 16 * b) * ld + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
          dp[a][b] = fmaf(dov[a], vv[b], dp[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const int row = row0 + r;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = col0 + tx + 16 * b;
        const bool in_range =
            row < Tq && col < Tk && (!causal || col <= row + shift);
        float p, ds;
        p_ds(s[a][b], dp[a][b], lse_s[r], delta_s[r], in_range, scale, &p,
             &ds);
        ds_s[r * kLdT + tx + 16 * b] = ds;
      }
    }
    __syncthreads();  // dS is complete

    for (int j = 0; j < kB; ++j) {
      float dsv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dsv[a] = ds_s[(ty + 16 * a) * kLdT + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float kv = k_s[j * ld + col];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(dsv[a], kv, acc[a][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + ty + 16 * a;
    if (row >= Tq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < D)
        dq[qbase + static_cast<size_t>(row) * D + col] = from_f32<T>(acc[a][c]);
    }
  }
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv,
                int BH, int Tq, int Tk, int D, int causal, float scale,
                cudaStream_t stream) {
  const size_t smem = dkdv_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(BH, (Tk + kB - 1) / kB);
  flash_dkdv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int BH, int Tq,
              int Tk, int D, int causal, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(BH, (Tq + kB - 1) / kB);
  flash_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Tq, Tk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, dout (BH, Tq, D) and k, v, dk, dv
// (BH, Tk, D) in that dtype; lse, delta (BH, Tq) float32; all contiguous on
// one device.  D <= 128 and a multiple of 8; BH, Tk >= 1 (the wrapper
// checks).  Returns cudaGetLastError() after the launch.
extern "C" int mx_flash_attention_dkdv(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv,
                                       int BH, int Tq, int Tk, int D,
                                       int causal, float scale,
                                       void* stream) {
  if (D > kMaxD || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dkdv<float>(q, k, v, dout, lse, delta, dk, dv, BH, Tq, Tk,
                              D, causal, scale, s);
  if (dtype == 1)
    return launch_dkdv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, BH,
                                      Tq, Tk, D, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above; dq (BH, Tq, D) in the inputs' dtype; BH, Tq >= 1.
extern "C" int mx_flash_attention_dq(int dtype, const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, int BH, int Tq, int Tk, int D,
                                     int causal, float scale, void* stream) {
  if (D > kMaxD || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dq<float>(q, k, v, dout, lse, delta, dq, BH, Tq, Tk, D,
                            causal, scale, s);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, BH, Tq, Tk,
                                    D, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
