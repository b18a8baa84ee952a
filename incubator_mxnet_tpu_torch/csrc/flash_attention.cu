// Flash attention forward (online softmax) for sm_90a.
//
// Replaces the Pallas TPU kernels `_fa_kernel_resident` and
// `_fa_kernel_streamed` launched by `_flash_core`
// (incubator_mxnet_tpu/ops/flash_attention.py).  The TPU needed two
// variants only because of its VMEM limit; here each kernel streams K/V
// tiles through shared memory at every length.  A block owns a tile of
// query rows of one batch*head and walks 64-key K/V tiles, each with the
// block math of `_fwd_block_update` -- f32 scores, mask, running (m, l, acc)
// with the fully-masked-row guards -- and writes out = acc / l and the row
// logsumexp, 0 and -inf on rows that see no key, as `_emit_out_lse`.
//
// Masking follows the TPU kernel: causal is bottom-right aligned (key j is
// visible to query i iff j - (Tk - Tq) <= i), ragged Tq / Tk tails are
// masked, and K/V tiles wholly past the diagonal are never loaded.
//
// Bound on the H100: 4*D flops a live (query, key) pair against q, k, v
// read and out, lse written once.  At the T=512 training inputs
// (8, 16, 512, 64) bf16 the two sit close, bytes 0.0101 ms at 3.35 TB/s
// against operations 0.0087 ms at 989 TFLOP/s; the causal
// (1, 16, 2048, 64) call is bound by operations (0.0087 ms against 0.0050).
//
// bfloat16 (namespace tc): every product is `wgmma.mma_async` m64n64k16
// bf16 -> f32, with the tile code of the backward (hopper_tc.cuh):
//
// * S = Q K^T with Q and K K-major from 128-byte-swizzled shared memory in
//   panels of 64 head columns; O += P V with P in registers -- S's
//   accumulator fragment, exponentiated in place and packed to bf16, is the
//   register A operand, the layout identity the backward relies on -- and V
//   read MN-major through the descriptor's transpose bit, n64 products a
//   64-column panel of O.  P never touches shared memory.  It goes to P V
//   as a bf16 pair, hi = bf16(p) and lo = bf16(p - hi), two products, as
//   dS in the backward: one rounding (the TPU's default-precision pass)
//   left outputs of BERT's T=512 activations an ulp of bf16 (0.03125)
//   from the plain version, past the port's bf16 tolerance of 2e-2.  l
//   sums the f32 values;
// * TMA loads the block's Q tile once and streams K and V through a ring of
//   three stages with mbarrier completion, so later tiles' copies overlap
//   the current tile's products.  TMA's zero fill covers the ragged Tq / Tk
//   tails and pads D up to the instantiated width (64 for D <= 64, 128
//   above);
// * warp specialisation: one producer warp issues the loads, and one or two
//   consumer warpgroups each own 64 query rows; `setmaxnreg` moves the
//   producer warpgroup's registers to the consumers.  O (64 x D f32 a
//   warpgroup, 32 or 64 registers a thread) and S (32) stay in registers
//   at D = 128, so there is no panel split;
// * the online softmax runs in registers in base 2: a row's max over the
//   fragment (16 entries a thread, then the quad's shuffles), m2 = scale *
//   log2(e) * max, p = exp2(s * scale * log2(e) - m2) as one FMA and
//   `ex2.approx`, alpha = exp2(m2_old - m2_new) rescaling l and O once a
//   tile; l stays a per-thread partial until the epilogue.  The mask runs
//   only on tiles that cross the diagonal or a ragged edge.  A row that
//   has seen no key keeps m2 = -inf (its exponent base is taken as 0, so
//   alpha and p are 0), ends with l = 0, and writes 0 and lse -inf;
//   lse = m2 * ln(2) + log(l) otherwise;
// * a warpgroup issues tile t's S beside tile t-1's P V, so t's softmax
//   runs on the CUDA cores while the tensor cores do t-1's P V;
// * grid (B*H, query tiles), the tiles that walk the most keys under causal
//   first; each block owns its output tile: no atomics, and two launches
//   give the same bits.  A block is one consumer warpgroup (64 rows, two
//   256-thread blocks an SM) at D <= 64 and two (128 rows, one 384-thread
//   block an SM) above, a ring of three stages, and S issued beside the
//   last tile's P V: of the variants timed on the H100 (128- or 64-row
//   blocks, two, three or four stages, with or without that overlap, three
//   64-row blocks an SM, blocks of one head launched together), these were
//   the fastest at (8, 16, 512, 64) and causal (1, 16, 2048, 64); at
//   D = 128 two 64-row blocks' rings do not fit in shared memory, and
//   three 64-row blocks an SM spill at 80 registers.
//
// The float32 path keeps the first design, products on the CUDA cores
// (256 threads, a 4x4 score sub-tile and a 4 x D/16 output sub-tile per
// thread, operands from shared memory): a tensor-core f32 product would be
// TF32, which does not meet the float32 tolerance.
#include <cfloat>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_tc.cuh"


namespace {

constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr int kThreads = 256;  // 16 x 16: ty owns rows, tx owns columns
constexpr int kMaxD = 128;
constexpr int kCols = kMaxD / 16;  // output columns per thread at D = 128

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int BH, int Tq, int Tk, int D, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(BH, (Tq + kBq - 1) / kBq);
  flash_fwd_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), Tq, Tk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ bfloat16 path
namespace tc {

constexpr int kRows = 64;        // rows of a warpgroup's query slice and of
                                 // a streamed key tile
constexpr int kStages = 3;       // ring of streamed K/V tiles
constexpr int kRowBytes = 128;   // 64 bf16 of a panel row, one swizzle span
constexpr int kProducerRegs = 24;
constexpr float kLn2 = 0.6931471805599453f;

// Threads, blocks an SM and consumer registers of a block of NWG consumer
// warpgroups and one producer warpgroup: the registers at launch fill the
// SM (65,536 / (threads * blocks), rounded down to 8), and the consumers
// take what the producer gives up.
template <int NWG>
struct Config {
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kBlocksPerSm = NWG == 1 ? 2 : 1;
  static constexpr int kLaunchRegs =
      (65536 / (kThreads * kBlocksPerSm)) / 8 * 8;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * (NWG + 1) - kProducerRegs) / NWG / 8 * 8;
};

// Shared memory: the Q tile (64 * NWG rows), a ring of K and V tiles (64
// rows), the barriers.  Tiles are panels of 64 head columns, each
// 1024-byte aligned.
template <int DP, int NWG>
struct FwdSmem {
  static constexpr int kPanels = DP / 64;
  static constexpr int kQRows = NWG * kRows;
  static constexpr int kQTile = kPanels * kQRows * kRowBytes;
  static constexpr int kTile = kPanels * kRows * kRowBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

// Stores rows row0 + 16*warp + lane/4 (+ 8) of a warpgroup's 64 x 64 f32
// accumulator, row i times mul[i], as bf16 into columns col0 .. col0 + 63
// of a (rows, D) matrix, skipping rows >= rows and columns >= D.
__device__ __forceinline__ void store_scaled(const float (&acc)[32],
                                             const float (&mul)[2],
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
            pack_bf16(acc[4 * j + 2 * i] * mul[i],
                      acc[4 * j + 2 * i + 1] * mul[i]);
    }
  }
}

// Block (bh, qt) owns queries [row0, row0 + 64 * NWG) of one (batch, head),
// the last query tiles first; consumer warpgroup wg owns 64 of them.  The
// entry e = 4j + 2i + c of a thread's S (and P) fragment sits in row
// 16*warp + lane/4 + 8i and key column 8j + 2*(lane%4) + c of the tile; of
// O's panel the same, over head columns.
template <int DP, int NWG>
__global__ void __launch_bounds__(Config<NWG>::kThreads,
                                  Config<NWG>::kBlocksPerSm)
fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Tq,
           int Tk, int D, int causal, float scale) {
  using L = FwdSmem<DP, NWG>;
  constexpr int kPanels = L::kPanels;
  constexpr int kQRows = L::kQRows;
  constexpr int kConsumers = 128 * NWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = q_full + 1;         // K, V of a stage landed
  uint64_t* empty = full + kStages;    // every consumer is done with it

  const int bh = blockIdx.x;
  // the last query tiles walk the most key tiles under causal: they go
  // first, so the short ones fill the tail of the launch
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kQRows;
  const int shift = Tk - Tq;
  // causal: key tiles whose first key is past the block's last row's
  // diagonal are fully masked -- the walk stops before them
  int nk = (Tk + kRows - 1) / kRows;
  if (causal) {
    const int lim = min(row0 + kQRows, Tq) - 1 + shift;
    nk = lim < 0 ? 0 : min(nk, lim / kRows + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
  if (wg == NWG) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (warp != 0 || lane != 0) return;
    mbar_expect_tx(q_full, L::kQTile);
    for (int c = 0; c < kPanels; ++c)
      tma_load(sm + L::kQ + c * kQRows * kRowBytes, &tm_q, q_full, 64 * c,
               row0, bh);
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
                 :: "n"(Config<NWG>::kConsumerRegs));
    const int q0 = row0 + kRows * wg;       // the warpgroup's first query
    const int qcol = 2 * (lane % 4);        // its column in 8 (and + 1)
    const uint32_t base = smem_u32(sm);
    const uint64_t q_desc = desc(base + L::kQ + kRows * kRowBytes * wg, 16);
    int rows[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) rows[i] = q0 + 16 * warp + lane / 4 + 8 * i;
    // the warpgroup's own walk: key tiles past its last row's diagonal,
    // or all of them when it has no row, are skipped
    int nk_wg = q0 < Tq ? nk : 0;
    if (causal && q0 < Tq) {
      const int lim = min(q0 + kRows, Tq) - 1 + shift;
      nk_wg = lim < 0 ? 0 : min(nk, lim / kRows + 1);
    }
    const float c1 = scale * kLog2e;        // >= 0 (the wrapper's contract)
    float o[kPanels][32];
#pragma unroll
    for (int c = 0; c < kPanels; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
    float m2[2] = {neg_inf(), neg_inf()};   // running max, base 2
    float l[2] = {0.f, 0.f};                // this thread's part of l
    // S of key tile t into st: product issued, not committed
    auto scores = [&](int t, float (&st)[32]) {
      const uint32_t k_s = base + L::kK + (t % kStages) * L::kTile;
      product_ss<DP, kQRows * kRowBytes, kRows * kRowBytes>(st, q_desc,
                                                            desc(k_s, 16));
    };
    // O += P V over key tile t's V, P as the bf16 pair (phi, plo):
    // products issued, not committed
    auto pv = [&](int t, const uint32_t (&phi)[16],
                  const uint32_t (&plo)[16]) {
      const uint32_t v_s = base + L::kV + (t % kStages) * L::kTile;
#pragma unroll
      for (int c = 0; c < kPanels; ++c) {
        const uint64_t v_panel = desc(v_s + c * kRows * kRowBytes, 1024);
        product_rs(o[c], phi, v_panel);
        product_rs(o[c], plo, v_panel);
      }
    };
    // P of key tile t in place of its S; updates m2 and l, returns alpha
    auto softmax = [&](int t, float (&st)[32], float (&alpha)[2]) {
      const int col0 = t * kRows;
      // entries past Tk or the diagonal: -inf for the max, p = 0 below
      const bool interior = col0 + kRows <= Tk &&
                            (!causal || col0 + kRows - 1 <= q0 + shift);
      uint32_t dead = 0;
      if (!interior) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * j + 2 * i + c;
              const int key = col0 + 8 * j + qcol + c;
              if (key >= Tk || (causal && key > rows[i] + shift)) {
                dead |= 1u << e;
                st[e] = neg_inf();
              }
            }
      }
      float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], st[4 * j + 2 * i]);
          mx[i] = fmaxf(mx[i], st[4 * j + 2 * i + 1]);
        }
      float neg_m[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m2[i], mx[i] * c1);
        // a row without a visible key so far keeps -inf; its base is 0,
        // so exp2(-inf - 0) gives alpha = 0 and p = 0
        const float m_use = m_new == neg_inf() ? 0.f : m_new;
        alpha[i] = ex2(m2[i] - m_use);
        neg_m[i] = -m_use;
        m2[i] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            const float p = ex2(fmaf(st[e], c1, neg_m[i]));
            st[e] = (dead >> e) & 1u ? 0.f : p;
            ps[i] += st[e];
          }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = fmaf(alpha[i], l[i], ps[i]);
    };
    auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int c = 0; c < kPanels; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];
    };
    mbar_wait(q_full, 0);
    // Tile t's S is issued beside tile t-1's P V, so t's softmax runs while
    // the tensor cores do t-1's P V; a stage is released once its P V is
    // done.  P goes to P V as a bf16 pair, phi = bf16(p) and plo =
    // bf16(p - phi), which carries it to ~2^-17: one rounding (2^-9) put
    // outputs of BERT's T=512 activations (|out| up to 4.9) an ulp of bf16
    // past the plain version, as dS in the backward.
    if (nk_wg > 0) {
      uint32_t phi[16], plo[16];
      float alpha[2];
      {
        float st[32];
        mbar_wait(&full[0], 0);
        wgmma_fence();
        scores(0, st);
        wgmma_commit();
        wgmma_wait<0>();
        hold(st);
        softmax(0, st, alpha);
        fragments(st, phi, &plo);
      }
      for (int t = 1; t < nk_wg; ++t) {
        float st[32];
        mbar_wait(&full[t % kStages], (t / kStages) & 1);
        wgmma_fence();
        scores(t, st);
        wgmma_commit();
        pv(t - 1, phi, plo);
        wgmma_commit();
        wgmma_wait<1>();
        hold(st);
        softmax(t, st, alpha);
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < kPanels; ++c) hold(o[c]);
        hold(phi);
        hold(plo);
        mbar_arrive(&empty[(t - 1) % kStages]);
        rescale(alpha);
        fragments(st, phi, &plo);
      }
      wgmma_fence();
      pv(nk_wg - 1, phi, plo);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kPanels; ++c) hold(o[c]);
      hold(phi);
      hold(plo);
      mbar_arrive(&empty[(nk_wg - 1) % kStages]);
    }
    // the block's tiles this warpgroup skips: waited for, then released
    for (int t = nk_wg; t < nk; ++t) {
      mbar_wait(&full[t % kStages], (t / kStages) & 1);
      mbar_arrive(&empty[t % kStages]);
    }
    if (q0 >= Tq) return;
    // the quad's parts of l; out = O / l, 0 on a row that saw no key
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
    }
    const size_t qbase = static_cast<size_t>(bh) * Tq;
#pragma unroll
    for (int c = 0; c < kPanels; ++c)
      store_scaled(o[c], inv, out + qbase * D, q0, Tq, 64 * c, D, warp,
                   lane);
    if (lane % 4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (rows[i] < Tq)
          lse[qbase + rows[i]] =
              l[i] > 0.f ? m2[i] * kLn2 + logf(l[i]) : neg_inf();
    }
  }
}

// Consumer warpgroups a block at head width DP: 64 query rows a block,
// two blocks an SM, at DP = 64 (the second block's loads and epilogue
// overlap the first's products); 128 rows, one block an SM, at DP = 128,
// where two blocks' rings do not fit in shared memory.
template <int DP>
constexpr int kWarpgroups = DP == 64 ? 1 : 2;

template <int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, int BH, int Tq, int Tk, int D, int causal,
               float scale, cudaStream_t stream) {
  constexpr int NWG = kWarpgroups<DP>;
  using L = FwdSmem<DP, NWG>;
  CUtensorMap mq, mk, mv;
  int err = tensor_map(&mq, q, BH, Tq, D, L::kQRows);
  // no key (Tk = 0): the walk is empty and K, V are never read; their maps
  // are built over one row of q so that they are valid
  const void* kp = Tk > 0 ? k : q;
  const void* vp = Tk > 0 ? v : q;
  if (!err) err = tensor_map(&mk, kp, BH, Tk > 0 ? Tk : 1, D, kRows);
  if (!err) err = tensor_map(&mv, vp, BH, Tk > 0 ? Tk : 1, D, kRows);
  if (err) return err;
  const int smem = L::kBytes + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      fwd_kernel<DP, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(BH, (Tq + L::kQRows - 1) / L::kQRows);
  fwd_kernel<DP, NWG><<<grid, Config<NWG>::kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      Tq, Tk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// Registers (at launch), local memory, dynamic shared memory and resident
// blocks an SM of the bf16 kernel instantiated for DP.
template <int DP>
int kernel_info(int* regs, int* local_bytes, int* smem, int* blocks_per_sm) {
  constexpr int NWG = kWarpgroups<DP>;
  const void* fn = reinterpret_cast<const void*>(fwd_kernel<DP, NWG>);
  *smem = FwdSmem<DP, NWG>::kBytes + 1024;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fn, Config<NWG>::kThreads, *smem);
  return static_cast<int>(e);
}

}  // namespace tc
}  // namespace

// What the bf16 kernel instantiated for head dim D uses: registers a
// thread at launch, local (spill) bytes, dynamic shared memory bytes, and
// how many of its blocks an SM holds; *rows_per_block the query rows of
// one block.
extern "C" int mx_flash_attention_fwd_info(int D, int* regs,
                                           int* local_bytes, int* smem,
                                           int* blocks_per_sm,
                                           int* rows_per_block) {
  if (D > kMaxD || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  *rows_per_block = (D <= 64 ? tc::kWarpgroups<64> : tc::kWarpgroups<128>) *
                    tc::kRows;
  return D <= 64
             ? tc::kernel_info<64>(regs, local_bytes, smem, blocks_per_sm)
             : tc::kernel_info<128>(regs, local_bytes, smem, blocks_per_sm);
}

// dtype: 0 = float32, 1 = bfloat16.  q, out (BH, Tq, D); k, v (BH, Tk, D);
// lse (BH, Tq) float32; all contiguous on one device, bfloat16 ones
// 16-byte aligned.  D <= 128 and a multiple of 8; BH, Tq >= 1; bfloat16
// needs scale >= 0 (the wrapper negates q for a negative scale).  Returns
// cudaGetLastError() after the launch.
extern "C" int mx_flash_attention_fwd(int dtype, const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int BH, int Tq, int Tk, int D,
                                      int causal, float scale, void* stream) {
  if (D > kMaxD || D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, out, lse, BH, Tq, Tk, D, causal, scale, s);
  if (dtype == 1) {
    if (!(scale >= 0.f)) return static_cast<int>(cudaErrorInvalidValue);
    return D <= 64 ? tc::launch_fwd<64>(q, k, v, out, lse, BH, Tq, Tk, D,
                                        causal, scale, s)
                   : tc::launch_fwd<128>(q, k, v, out, lse, BH, Tq, Tk, D,
                                         causal, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
