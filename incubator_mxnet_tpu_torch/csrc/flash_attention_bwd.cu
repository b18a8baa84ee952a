// Flash attention backward (dK/dV and dQ) for sm_90a.
//
// Replaces the Pallas TPU kernels `_fa_dkdv_kernel` and `_fa_dq_kernel`
// launched by `_flash_bwd_core` (incubator_mxnet_tpu/ops/flash_attention.py).
// Both recompute the probabilities from the forward's saved row logsumexp
// and never hold a (Tq, Tk) matrix: for a (query tile, key tile) pair they
// form S = Q K^T * scale, P = exp(S - lse), dP = dO V^T and
// dS = P * (dP - delta) * scale, with delta = rowsum(dO * O) (minus the lse
// cotangent in the (out, lse) variant), as `_bwd_block_terms` does.
//
// * dK/dV kernel: one block per (batch*head, key tile).  Its K and V tiles
//   stay in shared memory and its dK, dV sums in registers while it walks
//   the query tiles (Q, dO, lse, delta); per tile it adds P^T dO to dV and
//   dS^T Q to dK.
// * dQ kernel: one block per (batch*head, query tile).  Q, dO and the row
//   statistics stay; it walks the key tiles and adds dS K to dQ.
//
// On the TPU the output block was revisited along the grid's inner axis; here
// the walk is a loop inside the block, so each block owns its output tile:
// no atomics, and two launches on the same inputs give the same bits.  That
// is why dQ keeps a kernel of its own: a fused backward (FlashAttention-2/3)
// adds each key tile's dS K into dQ with atomics.  The pair recomputes S and
// dP in both kernels, 14*D flops a (query, key) pair against the 10*D of a
// fused backward.
//
// Masking follows the TPU kernels: causal is bottom-right aligned (key j is
// visible to query i iff j - (Tk - Tq) <= i), a 64x64 (query, key) tile pair
// wholly past the diagonal is never computed, ragged Tq / Tk tails are
// masked, and a row whose lse is -inf (it sees no key) contributes exactly 0:
// P uses exp(S - lse) only on valid entries.
//
// Bound on the H100: operations, 8*D flops a live pair in the dK/dV kernel
// and 6*D in the dQ kernel against O(D) bytes a 64-row tile (at
// (8, 16, 512, 64): 0.0174 and 0.0130 ms at 989 TFLOP/s against 0.003 ms
// of bytes).  The bfloat16 kernels are built for the tensor cores:
//
// * every product is `wgmma.mma_async` m64n64k16 bf16 -> f32.  dK/dV:
//   S^T = K Q^T and dP^T = V dO^T (M = 64 keys a warpgroup, N = 64
//   queries), then dV += P^T dO and dK += dS^T Q (N = 64 head columns).
//   dQ: S = Q K^T and dP = dO V^T (M = 64 queries, N = 64 keys), then
//   dQ += dS K;
// * P and dS never reach shared memory: they are formed in f32 from the
//   accumulators with the validity guard of `_bwd_block_terms` and fed
//   back in bf16 as the register A operand of the second products, whose
//   fragment layout is the first products' accumulator layout.  P is
//   rounded once (the pass the TPU's default-precision dot takes).  dS
//   goes as a pair hi = bf16(dS), lo = bf16(dS - hi) through two
//   products: each row of dS sums to 0, so dQ = dS K cancels the keys'
//   common part (a projection's bias, say) and dK does the same with the
//   queries', and one rounding of dS leaves 2^-9 of that part in the
//   result, which at BERT's T=512 activations exceeds the bf16 gradient
//   tolerance.  The pair costs one more m64n64 product a tile (10*D
//   flops a pair in the dK/dV kernel, 8*D in dQ; the bounds count the
//   algorithm's 8*D and 6*D);
// * operand tiles sit in shared memory in bf16 in the 128-byte-swizzled
//   layout the wgmma descriptors read, in panels of 64 head columns: K, V
//   resident and Q, dO streamed (dK/dV), Q, dO resident and K, V streamed
//   (dQ).  Each tile is staged once and read K-major by the first products
//   and MN-major (the transpose bit) by the second;
// * TMA loads them through 3-D tensor maps over (B*H, T, D) built on the
//   host, into a two-stage ring with mbarrier completion, so the next
//   tile's copy overlaps the current tile's products.  TMA's zero fill past
//   the tensor's extent covers the ragged T tails and pads D up to the
//   instantiated width (64 for D <= 64, 128 above).  lse and delta rows
//   are plain loads (the producer stages them for dK/dV; the dQ consumers
//   keep their rows in registers);
// * warp specialisation: a block is two consumer warpgroups, each owning
//   64 rows of the 128-row resident tile, and one producer warpgroup whose
//   first warp issues the loads; `setmaxnreg` moves the producer's
//   registers to the consumers (24 / 240).  384 threads at the launch's
//   168 registers fill the register file, so one block runs on an SM.  A
//   consumer holds one 64-column panel of its outputs (at D = 128 each
//   grid gets a third axis over the two panels, and each block recomputes
//   S and dP): S, dP and the outputs then fit without spilling;
// * the entries' math is a few instructions: P = exp2(S * scale * log2(e)
//   - lse2) on the SFU with lse2 = lse * log2(e) staged once a row (+inf
//   for a row without keys or past T, so its P is 0 with no test), the
//   mask only on tiles that cross the diagonal or a ragged edge, and
//   dS / scale = P (dP - delta), the scale applied to dK and dQ once in
//   the epilogue.  The dQ kernel commits S and dP as two groups, so P's
//   exponentials overlap the dP product, and starts the query tiles that
//   walk the most key tiles under causal first.
//
// The float32 kernels keep the first design, products on the CUDA cores
// (256 threads, a 4x4 sub-tile of S and dP per thread, operands widened in
// shared memory): a tensor-core f32 product would be TF32, which does not
// meet the float32 gradient tolerance, and no main path runs the backward in
// float32.
#include <cfloat>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_tc.cuh"

namespace {

constexpr int kB = 64;          // rows of a query tile and of a key tile
constexpr int kThreads = 256;   // 16 x 16: ty owns tile rows, tx columns
constexpr int kMaxD = 128;
constexpr int kCols = kMaxD / 16;   // accumulator columns per thread at D=128
constexpr int kLdT = kB + 1;        // leading dimension of a 64x64 f32 tile

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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


// ------------------------------------------------------------ bfloat16 path
// (the TMA, mbarrier and wgmma helpers are in hopper_tc.cuh)
namespace tc {

constexpr int kRows = 64;         // rows of a streamed tile and of a warpgroup
constexpr int kBlockRows = 128;   // rows of the resident tile (2 warpgroups)
constexpr int kStages = 2;        // ring of streamed tiles
constexpr int kConsumers = 256;   // threads of the two consumer warpgroups
constexpr int kThreads = 384;     // + one producer warpgroup
constexpr int kRowBytes = 128;    // 64 bf16 of a panel row, one swizzle span
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared memory of the dK/dV kernel: K and V (128 rows), a ring of Q and
// dO tiles (64 rows) with their lse and delta rows, the barriers.  Tiles
// are panels of 64 head columns, each 1024-byte aligned.
template <int DP>
struct DkdvSmem {
  static constexpr int kPanels = DP / 64;
  static constexpr int kTileBig = kPanels * kBlockRows * kRowBytes;
  static constexpr int kTile = kPanels * kRows * kRowBytes;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTileBig;
  static constexpr int kQ = kV + kTileBig;
  static constexpr int kDO = kQ + kStages * kTile;
  static constexpr int kLse = kDO + kStages * kTile;
  static constexpr int kDelta = kLse + kStages * kRows * 4;
  static constexpr int kBar = kDelta + kStages * kRows * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
};

// Shared memory of the dQ kernel: Q and dO (128 rows), a ring of K and V
// tiles (64 rows), the barriers.
template <int DP>
struct DqSmem {
  static constexpr int kPanels = DP / 64;
  static constexpr int kTileBig = kPanels * kBlockRows * kRowBytes;
  static constexpr int kTile = kPanels * kRows * kRowBytes;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kTileBig;
  static constexpr int kK = kDO + kTileBig;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
};

// A row's lse in base 2, as the terms below take it: lse * log2(e), or
// +inf when the row sees no key (lse -inf, or not finite) or lies past
// T, so that its P is exp2(-inf) = 0 with no test an entry.
__device__ __forceinline__ float lse_base2(float lse, bool in) {
  return in && is_finite(lse) ? lse * kLog2e
                              : __int_as_float(0x7f800000);
}

// The tile's P, in place of S (st), as `_bwd_block_terms`:
// p = exp2(s * scale * log2(e) - lse2), zero where the entry is masked.
// The entry e = 4j + 2i + c of a thread sits in accumulator row i and
// column 8j + c (plus the thread's offsets); ``terms(j, i, c)`` gives its
// (lse2, delta), ``visible(j, i, c)`` whether it is in range.  Interior
// tiles (every entry in range) skip the mask.
template <bool kInterior, typename Terms, typename Visible>
__device__ __forceinline__ void tile_p(float (&st)[32], float c1, Terms terms,
                                       Visible visible) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        const float p = ex2(fmaf(st[e], c1, -terms(j, i, c).x));
        st[e] = kInterior || visible(j, i, c) ? p : 0.f;
      }
}

// dS / scale = p * (dp - delta) of the tile's entries, in place of dP.
template <typename Terms>
__device__ __forceinline__ void tile_ds(const float (&p)[32],
                                        float (&dpt)[32], Terms terms) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        dpt[e] = p[e] * (dpt[e] - terms(j, i, c).y);
      }
}

// Stores rows row0 + 16*warp + lane/4 (+ 8) of a warpgroup's 64 x 64 f32
// accumulator times ``mul`` as bf16 into columns col0 .. col0 + 63 of a
// (rows, D) matrix, skipping rows >= rows and columns >= D.
__device__ __forceinline__ void store_rows(const float (&acc)[32], float mul,
                                           __nv_bfloat16* __restrict__ out,
                                           int row0, int rows, int col0,
                                           int D, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + lane / 4 + 8 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + 8 * j + 2 * (lane % 4);
      if (col < D)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * D +
                                     col) =
            pack_bf16(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
    }
  }
}

// The dK/dV kernel.  Block (bh, kt, pn) owns keys [128*kt, 128*kt + 128)
// of one (batch, head) and head columns [64*pn, 64*pn + 64) of their dK
// and dV; consumer warpgroup wg owns 64 of the keys.  At DP = 128 the two
// column panels are two blocks, which recompute S and dP: one panel of
// dK and dV (64 registers a thread) beside S and dP keeps a consumer
// within 168 registers without spilling.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_do,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int Tq, int Tk, int D, int causal, float scale) {
  using L = DkdvSmem<DP>;
  constexpr int kPanels = L::kPanels;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = kv_full + 1;        // Q, dO, lse, delta of a stage landed
  uint64_t* empty = full + kStages;    // both warpgroups are done with it
  float* lse_s = reinterpret_cast<float*>(sm + L::kLse);
  float* delta_s = reinterpret_cast<float*>(sm + L::kDelta);

  const int bh = blockIdx.x;
  const int col0 = blockIdx.y * kBlockRows;
  const int pn = blockIdx.z;            // the output's column panel
  const int shift = Tk - Tq;
  // causal: query tiles whose last row's diagonal lies before the block's
  // first key see none of it -- start the walk after them
  int qb0 = 0;
  if (causal) {
    const int x = col0 - shift;
    qb0 = x > 0 ? x / kRows : 0;
  }
  const int nt = max((Tq + kRows - 1) / kRows - qb0, 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  if (wg == 2) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (warp != 0) return;
    const float* lse_bh = lse + static_cast<size_t>(bh) * Tq;
    const float* delta_bh = delta + static_cast<size_t>(bh) * Tq;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::kTileBig);
      for (int c = 0; c < kPanels; ++c) {
        const int off = c * kBlockRows * kRowBytes;
        tma_load(sm + L::kK + off, &tm_k, kv_full, 64 * c, col0, bh);
        tma_load(sm + L::kV + off, &tm_v, kv_full, 64 * c, col0, bh);
      }
    }
    for (int t = 0; t < nt; ++t) {
      const int s = t % kStages;
      mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      const int row0 = (qb0 + t) * kRows;
      for (int r = lane; r < kRows; r += 32) {
        const bool in = row0 + r < Tq;
        lse_s[s * kRows + r] = lse_base2(in ? lse_bh[row0 + r] : 0.f, in);
        delta_s[s * kRows + r] = in ? delta_bh[row0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * L::kTile);
        for (int c = 0; c < kPanels; ++c) {
          const int off = s * L::kTile + c * kRows * kRowBytes;
          tma_load(sm + L::kQ + off, &tm_q, &full[s], 64 * c, row0, bh);
          tma_load(sm + L::kDO + off, &tm_do, &full[s], 64 * c, row0, bh);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int key0 = col0 + kRows * wg;     // the warpgroup's first key
    const int krow = 16 * warp + lane / 4;  // its row of S^T (and + 8)
    const int qcol = 2 * (lane % 4);        // its column in 8 (and + 1)
    const uint32_t base = smem_u32(sm);
    const uint64_t k_desc = desc(base + L::kK + kRows * kRowBytes * wg, 16);
    const uint64_t v_desc = desc(base + L::kV + kRows * kRowBytes * wg, 16);
    const float c1 = scale * kLog2e;
    float acc_dk[32], acc_dv[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc_dk[e] = acc_dv[e] = 0.f;
    const bool has_keys = key0 < Tk;
    mbar_wait(kv_full, 0);
    for (int t = 0; t < nt; ++t) {
      const int s = t % kStages;
      mbar_wait(&full[s], (t / kStages) & 1);
      const int row0 = (qb0 + t) * kRows;
      if (has_keys && (!causal || key0 <= row0 + kRows - 1 + shift)) {
        const uint32_t q_s = base + L::kQ + s * L::kTile;
        const uint32_t do_s = base + L::kDO + s * L::kTile;
        float st[kRows / 2], dpt[kRows / 2];
        wgmma_fence();
        product_ss<DP, kBlockRows * kRowBytes, kRows * kRowBytes>(
            st, k_desc, desc(q_s, 16));
        product_ss<DP, kBlockRows * kRowBytes, kRows * kRowBytes>(
            dpt, v_desc, desc(do_s, 16));
        wgmma_commit();
        wgmma_wait<0>();
        hold(st);
        hold(dpt);
        // P^T and dS^T / scale in f32, in place of S^T and dP^T; the
        // entries' lse2 and delta are their query columns'.  (Unlike the
        // dQ kernel, this one takes S^T and dP^T as one group: holding
        // P^T's fragments beside dP^T while the dV product runs costs it
        // more registers than the overlap gains.)
        const float* lse_t = lse_s + s * kRows;
        const float* delta_t = delta_s + s * kRows;
        auto col_terms = [&](int j, int, int c) {
          return make_float2(lse_t[8 * j + qcol + c],
                             delta_t[8 * j + qcol + c]);
        };
        auto visible = [&](int j, int i, int c) {
          const int q = row0 + 8 * j + qcol + c;
          const int key = key0 + krow + 8 * i;
          return q < Tq && key < Tk && (!causal || key <= q + shift);
        };
        if (row0 + kRows <= Tq && key0 + kRows <= Tk &&
            (!causal || key0 + kRows - 1 <= row0 + shift))
          tile_p<true>(st, c1, col_terms, visible);
        else
          tile_p<false>(st, c1, col_terms, visible);
        tile_ds(st, dpt, col_terms);
        // dV += P^T dO with P^T in bf16; dK += dS^T Q / scale with dS^T
        // as a bf16 pair (hi + lo): the rows of dS sum to 0, so one bf16
        // rounding of dS would leave errors of 2^-9 |dS| |Q| against sums
        // that cancel
        const uint32_t ob = pn * kRows * kRowBytes;
        uint32_t pf[16], dsh[16], dsl[16];
        fragments(st, pf);
        wgmma_fence();
        product_rs(acc_dv, pf, desc(do_s + ob, 1024));
        fragments(dpt, dsh, &dsl);
        wgmma_fence();
        product_rs(acc_dk, dsh, desc(q_s + ob, 1024));
        product_rs(acc_dk, dsl, desc(q_s + ob, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        hold(acc_dk);
        hold(acc_dv);
        hold(pf);
        hold(dsh);
        hold(dsl);
      }
      mbar_arrive(&empty[s]);
    }
    if (!has_keys) return;
    const size_t kbase = static_cast<size_t>(bh) * Tk * D;
    store_rows(acc_dk, scale, dk + kbase, key0, Tk, 64 * pn, D, warp, lane);
    store_rows(acc_dv, 1.f, dv + kbase, key0, Tk, 64 * pn, D, warp, lane);
  }
}

// The dQ kernel.  Block (bh, qt, pn) owns queries [128*qt, 128*qt + 128)
// of one (batch, head) and head columns [64*pn, 64*pn + 64) of their dQ;
// consumer warpgroup wg owns 64 of the queries.  As in the dK/dV kernel,
// the two panels at DP = 128 are two blocks.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __grid_constant__ CUtensorMap tm_do,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int Tq, int Tk, int D, int causal,
          float scale) {
  using L = DqSmem<DP>;
  constexpr int kPanels = L::kPanels;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = qdo_full + 1;       // K, V of a stage landed
  uint64_t* empty = full + kStages;    // both warpgroups are done with it

  const int bh = blockIdx.x;
  // the last query tiles walk the most key tiles under causal: they go
  // first, so the short ones fill the tail of the launch
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;
  const int pn = blockIdx.z;            // the output's column panel
  const int shift = Tk - Tq;
  // causal: key tiles whose first key is past the block's last row's
  // diagonal are fully masked -- stop the walk before them
  int nk = (Tk + kRows - 1) / kRows;
  if (causal) {
    const int lim = row0 + kBlockRows - 1 + shift;
    nk = lim < 0 ? 0 : min(nk, lim / kRows + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  if (wg == 2) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (warp != 0 || lane != 0) return;
    mbar_expect_tx(qdo_full, 2 * L::kTileBig);
    for (int c = 0; c < kPanels; ++c) {
      const int off = c * kBlockRows * kRowBytes;
      tma_load(sm + L::kQ + off, &tm_q, qdo_full, 64 * c, row0, bh);
      tma_load(sm + L::kDO + off, &tm_do, qdo_full, 64 * c, row0, bh);
    }
    for (int t = 0; t < nk; ++t) {
      const int s = t % kStages;
      mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      mbar_expect_tx(&full[s], 2 * L::kTile);
      for (int c = 0; c < kPanels; ++c) {
        const int off = s * L::kTile + c * kRows * kRowBytes;
        tma_load(sm + L::kK + off, &tm_k, &full[s], 64 * c, t * kRows, bh);
        tma_load(sm + L::kV + off, &tm_v, &full[s], 64 * c, t * kRows, bh);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int q0 = row0 + kRows * wg;       // the warpgroup's first query
    const int qcol = 2 * (lane % 4);        // its column in 8 (and + 1)
    const uint32_t base = smem_u32(sm);
    const uint64_t q_desc = desc(base + L::kQ + kRows * kRowBytes * wg, 16);
    const uint64_t do_desc = desc(base + L::kDO + kRows * kRowBytes * wg, 16);
    int rows[2];
    float lse_r[2], delta_r[2];
    const size_t rbase = static_cast<size_t>(bh) * Tq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rows[i] = q0 + 16 * warp + lane / 4 + 8 * i;
      const bool in = rows[i] < Tq;
      lse_r[i] = lse_base2(in ? lse[rbase + rows[i]] : 0.f, in);
      delta_r[i] = in ? delta[rbase + rows[i]] : 0.f;
    }
    const float c1 = scale * kLog2e;
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    const bool has_rows = q0 < Tq;
    mbar_wait(qdo_full, 0);
    for (int t = 0; t < nk; ++t) {
      const int s = t % kStages;
      mbar_wait(&full[s], (t / kStages) & 1);
      const int col0 = t * kRows;
      if (has_rows && (!causal || col0 <= q0 + kRows - 1 + shift)) {
        const uint32_t k_s = base + L::kK + s * L::kTile;
        const uint32_t v_s = base + L::kV + s * L::kTile;
        float st[32], dpt[32];
        // S and dP as two groups: P's exponentials run while the tensor
        // cores compute dP
        wgmma_fence();
        product_ss<DP, kBlockRows * kRowBytes, kRows * kRowBytes>(
            st, q_desc, desc(k_s, 16));
        wgmma_commit();
        product_ss<DP, kBlockRows * kRowBytes, kRows * kRowBytes>(
            dpt, do_desc, desc(v_s, 16));
        wgmma_commit();
        // P and dS / scale in f32, in place of S and dP; the entries'
        // lse2 and delta are their query rows'
        auto row_terms = [&](int, int i, int) {
          return make_float2(lse_r[i], delta_r[i]);
        };
        auto visible = [&](int j, int i, int c) {
          const int key = col0 + 8 * j + qcol + c;
          return rows[i] < Tq && key < Tk &&
                 (!causal || key <= rows[i] + shift);
        };
        wgmma_wait<1>();
        hold(st);
        if (q0 + kRows <= Tq && col0 + kRows <= Tk &&
            (!causal || col0 + kRows - 1 <= q0 + shift))
          tile_p<true>(st, c1, row_terms, visible);
        else
          tile_p<false>(st, c1, row_terms, visible);
        wgmma_wait<0>();
        hold(dpt);
        tile_ds(st, dpt, row_terms);
        // dQ += dS K / scale with dS as a bf16 pair (hi + lo): the rows
        // of dS sum to 0, so dQ cancels the keys' common part, which one
        // bf16 rounding of dS would leave in it at 2^-9
        uint32_t dsh[16], dsl[16];
        fragments(dpt, dsh, &dsl);
        wgmma_fence();
        const uint64_t k_panel = desc(k_s + pn * kRows * kRowBytes, 1024);
        product_rs(acc, dsh, k_panel);
        product_rs(acc, dsl, k_panel);
        wgmma_commit();
        wgmma_wait<0>();
        hold(acc);
        hold(dsh);
        hold(dsl);
      }
      mbar_arrive(&empty[s]);
    }
    if (!has_rows) return;
    store_rows(acc, scale, dq + static_cast<size_t>(bh) * Tq * D, q0, Tq,
               64 * pn, D, warp, lane);
  }
}

template <int DP>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv,
                int BH, int Tq, int Tk, int D, int causal, float scale,
                cudaStream_t stream) {
  const size_t out_bytes = static_cast<size_t>(BH) * Tk * D * 2;
  if (Tq == 0) {  // no query: both gradients are 0
    cudaError_t err = cudaMemsetAsync(dk, 0, out_bytes, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, out_bytes, stream);
    return static_cast<int>(err);
  }
  CUtensorMap mq, mk, mv, mdo;
  int err = tensor_map(&mq, q, BH, Tq, D, kRows);
  if (!err) err = tensor_map(&mk, k, BH, Tk, D, kBlockRows);
  if (!err) err = tensor_map(&mv, v, BH, Tk, D, kBlockRows);
  if (!err) err = tensor_map(&mdo, dout, BH, Tq, D, kRows);
  if (err) return err;
  const int smem = DkdvSmem<DP>::kBytes + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      dkdv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(BH, (Tk + kBlockRows - 1) / kBlockRows, DP / 64);
  dkdv_kernel<DP><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Tq, Tk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int BH, int Tq,
              int Tk, int D, int causal, float scale, cudaStream_t stream) {
  if (Tk == 0)  // no key: dq is 0
    return static_cast<int>(cudaMemsetAsync(
        dq, 0, static_cast<size_t>(BH) * Tq * D * 2, stream));
  CUtensorMap mq, mk, mv, mdo;
  int err = tensor_map(&mq, q, BH, Tq, D, kBlockRows);
  if (!err) err = tensor_map(&mk, k, BH, Tk, D, kRows);
  if (!err) err = tensor_map(&mv, v, BH, Tk, D, kRows);
  if (!err) err = tensor_map(&mdo, dout, BH, Tq, D, kBlockRows);
  if (err) return err;
  const int smem = DqSmem<DP>::kBytes + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(BH, (Tq + kBlockRows - 1) / kBlockRows, DP / 64);
  dq_kernel<DP><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), Tq,
      Tk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// Registers (at launch), local memory, dynamic shared memory and resident
// blocks an SM of one bf16 kernel: dq selects the dQ kernel.
template <int DP>
int kernel_info(int dq, int* regs, int* local_bytes, int* smem,
                int* blocks_per_sm) {
  const void* fn = dq ? reinterpret_cast<const void*>(dq_kernel<DP>)
                      : reinterpret_cast<const void*>(dkdv_kernel<DP>);
  *smem = (dq ? DqSmem<DP>::kBytes : DkdvSmem<DP>::kBytes) + 1024;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                      kThreads, *smem);
  return static_cast<int>(e);
}

}  // namespace tc
}  // namespace

// What the bf16 kernel (dq = 0: dK/dV, 1: dQ) instantiated for head dim D
// uses: registers a thread at launch, local (spill) bytes, dynamic shared
// memory bytes, and how many of its blocks an SM holds.
extern "C" int mx_flash_attention_bwd_info(int dq, int D, int* regs,
                                           int* local_bytes, int* smem,
                                           int* blocks_per_sm) {
  if (D > kMaxD || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return D <= 64 ? tc::kernel_info<64>(dq, regs, local_bytes, smem,
                                       blocks_per_sm)
                 : tc::kernel_info<128>(dq, regs, local_bytes, smem,
                                        blocks_per_sm);
}

// dtype: 0 = float32, 1 = bfloat16.  q, dout (BH, Tq, D) and k, v, dk, dv
// (BH, Tk, D) in that dtype; lse, delta (BH, Tq) float32; all contiguous on
// one device, bfloat16 ones 16-byte aligned.  D <= 128 and a multiple of 8;
// BH, Tk >= 1 (the wrapper checks).  Returns cudaGetLastError() after the
// launch.
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
    return D <= 64 ? tc::launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv,
                                         BH, Tq, Tk, D, causal, scale, s)
                   : tc::launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv,
                                          BH, Tq, Tk, D, causal, scale, s);
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
    return D <= 64 ? tc::launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, Tq,
                                       Tk, D, causal, scale, s)
                   : tc::launch_dq<128>(q, k, v, dout, lse, delta, dq, BH,
                                        Tq, Tk, D, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
