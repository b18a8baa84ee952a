// int8 post-training-quantized convolution for sm_90a: an implicit GEMM on
// the int8 tensor cores (s8 `wgmma`) over the channels-last int8 buffer
// that int8_quantize.cu writes once a layer, with split-K for outputs too
// small to fill the card, and the per-channel rescale and bias in the
// epilogue.
//
// Replaces no Pallas kernel: the JAX package's `int8_conv`
// (incubator_mxnet_tpu/contrib/quantization.py:113-136) asks XLA for an
// s8 x s8 -> s32 `conv_general_dilated`, and torch has no int8
// convolution on CUDA (cuDNN and `F.conv*` take no int8 operands there),
// so the port writes it.  Its GEMM case (a 1x1 convolution over
// (M, K, 1, 1)) is `int8_dense` (`:96-110`).  For x of type T (float or
// bf16), NC[D]HW with 1-3 spatial dims, the two kernels compute
//
//   xq  = clip(round_half_even(x / act_scale), -127, 127)      as s8
//   acc = sum over (c, kd, kh, kw) of xq * w_q                  in s32
//   out = T(f32(acc) * scale[o] + bias[o])
//
// with groups, stride, symmetric padding (zeros, so quantized 0) and
// dilation; scale[o] = act_scale * w_scale[o] is staged by the caller in
// f32.  Exactness against the plain version (`int8_conv_reference`): the
// quantize is int8_quantize.cu's IEEE division; the sum is exact in s32 in
// any order (|acc| <= K * 127^2), so tensor cores, the (tap, channel) order
// of K and split-K keep the bits; the epilogue is `__fmul_rn` then
// `__fadd_rn`, which nvcc does not contract into an FMA, as the plain
// version's two torch ops round twice.
//
// Bound on the H100, per layer the larger of the bytes (x read once, the
// int8 weights, the output written once) over 3.35 TB/s and 2 x the
// multiply-adds over the int8 dense tensor-core peak of 1,979 TOPS.  Most of
// ResNet-50's layers move more bytes than their products take time: a 3x3
// 64->64 at 56x56 does 9 x 64 = 576 multiply-adds a byte of its bf16 input,
// under the ~590 that the peak needs for every byte of HBM; the deep 3x3s
// (K = 2304-4608) and the wide 1x1s sit near or above the line.  The
// design against each:
//
// * bytes: x is read once, by the quantize pass, which writes one byte an
//   element (the padding lanes of Cp excepted; for a strided 1x1 only the
//   pixels read; for a kernel over few channels, such as the stem's 3,
//   its width taps folded into the channels, so a tap is not 16 bytes
//   for 3); this kernel reads that buffer -- a 3x3 tap's pixels again
//   from L2, not HBM -- and the packed weights, and writes the output
//   once, in x's type, NC[D]HW, through shared memory so that a warp
//   writes consecutive pixels of one channel, up to 4 a thread;
// * operations: the products are `wgmma.mma_async` m64nNk32 s8 x s8 -> s32
//   (1,979 TOPS dense), both operands K-major in 128-byte-swizzled shared
//   memory.  A tile is 128 x N of (output pixel, output channel) of one
//   group, two consumer warpgroups of 64 pixels each, N = 64, 128 or 256
//   from O/G, so that an A tile is read once per 256 output channels
//   (per layer where O/G <= 256);
// * latency: K runs in (tap, channel) order in 128-byte stages through a
//   ring of 6, 4 or 3 (at N = 64, 128, 256), with `mbarrier`s.  B
//   (weights packed once as (G, O/G, taps, Cp)) comes by TMA, a 2-D box
//   of N rows x 128 bytes.  A comes by TMA too where it can: for a 1x1
//   convolution without padding (the buffer's rows are the GEMM's, 36
//   of ResNet-50's 53 layers and the Dense) a 2-D box; where Cp is a
//   multiple of 128, a 5-D box of one tap over a tile that is itself a
//   box of output pixels (powers of two in w, h, d, n; out-of-range
//   coordinates read the padding's zeros, and the strides are TMA's
//   element strides).  Elsewhere (Cp of 16-64: the stem's fold, the 3x3s
//   over 64 channels) a producer warpgroup gathers it in 16-byte
//   `cp.async` copies, one a (pixel, 16 channels of one tap), src-size 0
//   in the padding and past K, completing on the stage's barrier.  The
//   blocks are persistent, one an SM, each walking every gridDim-th
//   tile: the producer runs ahead into the next tiles' stages while the
//   consumers apply the epilogue in registers, stage x's type in shared
//   memory and copy it out, so a layer of short K (a 1x1 over 64
//   channels is one stage) does not wait out a load latency a tile;
// * a small grid: where fewer tiles than SMs exist (every layer at B=1,
//   the Dense), K is split over blocks, each writing its s32 partial tile
//   to a workspace (S, O, M) that the wrapper allocates; a second kernel
//   of this file sums the partials in a fixed order and applies the
//   epilogue.  No atomics: two launches give the same bits.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_tc.cuh"

namespace {
namespace tc {

constexpr int kBM = 128;            // output pixels a tile
constexpr int kBK = 128;            // K bytes a stage, one swizzle row
constexpr int kChunks = kBK / 16;   // 16-byte copies a row a stage
constexpr int kConsumers = 256;     // warpgroups 0 and 1: 64 pixels each
constexpr int kProducers = 128;     // warpgroup 2
constexpr int kThreads = kConsumers + kProducers;
constexpr int kStageRow = kBM + 4;  // a staged output channel, s32 words
constexpr int kEpilogueThreads = 256;

// How a tile's A stage comes: gathered by cp.async, 16 bytes a (pixel,
// tap, 16 channels) with zeros in the padding; a 2-D TMA box of the
// buffer's rows (a 1x1 convolution without padding over its own pixels);
// or a 5-D TMA box (channels, w, h, d, n) of 128 bytes of one tap (Cp a
// multiple of 128), whose out-of-range coordinates read zeros (the
// padding), the tile a box of bw x bh x bd x bn output pixels taken at
// the strides.
enum Mode { kGather = 0, kDense = 1, kTiled = 2 };

struct ConvShape {
  long long n;                 // batch
  int o, groups, cp;           // channels out, groups, xq bytes a group
  int id, ih, iw;              // xq's spatial extents (1 where absent)
  int od, oh, ow;              // output spatial extents
  int kd, kh, kw;              // taps
  int sd, sh, sw;              // strides
  int pd, ph, pw;              // padding (both sides)
  int dd, dh, dw;              // dilations
};

struct TileShape {
  int mode;                    // Mode
  int bw, bh, bd, bn;          // a tiled tile's box of output pixels
  int vec;                     // pixels a thread writes at once
};

// Dynamic shared memory, 1024-byte aligned: the ring of stages (A, 128
// rows x 128 bytes, then B, BN rows x 128; 6, 4, 3 of them at 64, 128,
// 256 channels), the staged output of up to 128 channels, the rows' input
// coordinates, the tile's scales and biases, the barriers.
template <int BN>
struct Smem {
  static constexpr int kStages = BN == 64 ? 6 : BN == 128 ? 4 : 3;
  static constexpr int kCols = BN < 128 ? BN : 128;     // staged at once
  static constexpr int kATile = kBM * kBK;
  static constexpr int kStageBytes = (kBM + BN) * kBK;
  static constexpr int kStage = kStages * kStageBytes;  // s32 [col][row]
  static constexpr int kRows = kStage + 4 * kCols * kStageRow;  // int4
  static constexpr int kScale = kRows + 16 * kBM;       // float a channel
  static constexpr int kBias = kScale + 4 * BN;
  static constexpr int kBar = kBias + 4 * BN;
  static constexpr int kBytes = kBar + 8 * 2 * kStages;
};

__device__ __forceinline__ float epilogue(int acc, float scale, float bias,
                                          bool has_bias) {
  const float v = __fmul_rn(__int2float_rn(acc), scale);
  return has_bias ? __fadd_rn(v, bias) : v;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 2, %0;\n" :: "n"(kProducers) : "memory");
}

// A tile: its pixels (mt, the m_tiles-th part of the output), channels
// [nt BN, + BN) of group g, K stages [kb0, kb1) of split s.  Tiles run
// pixels fastest, so the blocks running together share a weight tile in
// L2.  Gather and dense tiles are 128 consecutive output pixels from
// 128 mt; a tiled one the box at (x0, y0, z0, n0) of the output.
struct Tile {
  int mt, g, nt, split, kb0, kb1;
  int x0, y0, z0, n0;
};

__device__ __forceinline__ Tile tile_of(int t, int m_tiles, int n_tiles,
                                        int groups, int nkb, int splits,
                                        const ConvShape& sh,
                                        const TileShape& ts) {
  Tile w;
  w.mt = t % m_tiles;
  const int rest = t / m_tiles;
  const int y = rest % (n_tiles * groups);
  w.split = rest / (n_tiles * groups);
  w.g = y / n_tiles;
  w.nt = y - w.g * n_tiles;
  w.kb0 = static_cast<int>(static_cast<long long>(w.split) * nkb / splits);
  w.kb1 = static_cast<int>(static_cast<long long>(w.split + 1) * nkb /
                           splits);
  if (ts.mode == kTiled) {
    const int tw = (sh.ow + ts.bw - 1) / ts.bw;
    const int th = (sh.oh + ts.bh - 1) / ts.bh;
    const int td = (sh.od + ts.bd - 1) / ts.bd;
    int r = w.mt;
    w.x0 = (r % tw) * ts.bw;
    r /= tw;
    w.y0 = (r % th) * ts.bh;
    r /= th;
    w.z0 = (r % td) * ts.bd;
    w.n0 = (r / td) * ts.bn;
  }
  return w;
}

// The output pixel (its index in N*OD*OH*OW) of row r of tile w, or -1.
__device__ __forceinline__ int pixel_of(int r, const Tile& w, int M,
                                        const ConvShape& sh,
                                        const TileShape& ts) {
  if (ts.mode != kTiled) {
    const int m = w.mt * kBM + r;
    return m < M ? m : -1;
  }
  const int x = w.x0 + r % ts.bw;
  r /= ts.bw;
  const int y = w.y0 + r % ts.bh;
  r /= ts.bh;
  const int z = w.z0 + r % ts.bd;
  const int n = w.n0 + r / ts.bd;
  if (x >= sh.ow || y >= sh.oh || z >= sh.od || n >= sh.n) return -1;
  return ((n * sh.od + z) * sh.oh + y) * sh.ow + x;
}

// The write of one staged chunk of kCols channels: a thread owns V rows
// that are consecutive output pixels of one image (V divides OD*OH*OW,
// or, tiled, the box's and the output's width), adjacent in out, and
// every (2V)-th channel; a warp writes 32 V consecutive pixels of one
// channel, V at a time.  S is the staged type: x's type (the epilogue
// already applied) into out, or the s32 partial into ws_row (ws[split]).
template <int V, int kCols, typename S, typename D>
__device__ __forceinline__ void write_chunk(const S* stage, int tid,
                                           const Tile& w, int M,
                                           const ConvShape& sh,
                                           const TileShape& ts, int cols,
                                           int c0, D* dst, long long dstep,
                                           bool to_out) {
  constexpr int kPer = kBM / V;            // threads a channel
  constexpr int kStep = kConsumers / kPer;  // channels a pass
  const int q = tid % kPer;
  const int m = pixel_of(V * q, w, M, sh, ts);
  if (m < 0) return;
  long long at = m;                        // ws: the pixel's index
  if (to_out) {                            // out: (n, channel 0, pixel)
    const int osp = sh.od * sh.oh * sh.ow;
    const int nb = m / osp;
    at = static_cast<long long>(nb) * sh.o * osp + (m - nb * osp);
  }
  // the trip count first, then a loop unrolled 4 deep, so that several
  // channels' loads and stores are in flight at once
  const int col0 = tid / kPer;
  const int left = min(kCols, cols - c0) - col0;
  const int n = left > 0 ? (left + kStep - 1) / kStep : 0;
  D* p = dst + at + (c0 + col0) * dstep;
#pragma unroll 4
  for (int i = 0; i < n; ++i)
    *reinterpret_cast<Vec<D, V>*>(p + i * kStep * dstep) =
        *reinterpret_cast<const Vec<S, V>*>(
            stage + (col0 + kStep * i) * kStageRow + V * q);
}

// Persistent blocks, one an SM: block b runs tiles b, b + gridDim.x, ...
// The producer warpgroup keeps the ring full across tiles, so the next
// tile's loads overlap this tile's epilogue: all of it for a gathered A
// (the rows of the tile it loads are its own), its first thread alone
// for TMA.  The two consumer warpgroups multiply their 64 pixels each,
// then stage the tile through shared memory, up to 128 channels at a
// time, and write it.  With one split they apply the epilogue in
// registers, stage x's type and write out; else they stage the s32
// partial and write it to ws[split].
template <int BN, typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv_kernel(const __grid_constant__ CUtensorMap tm_w,
            const __grid_constant__ CUtensorMap tm_a,
            const int8_t* __restrict__ xq, const float* __restrict__ scale,
            const float* __restrict__ bias, T* __restrict__ out,
            int* __restrict__ ws, ConvShape sh, TileShape ts, int splits) {
  using L = Smem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  int4* rows = reinterpret_cast<int4*>(sm + L::kRows);
  float* sc = reinterpret_cast<float*>(sm + L::kScale);
  float* bi = reinterpret_cast<float*>(sm + L::kBias);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  constexpr int S = L::kStages;
  constexpr int a_bytes = L::kATile;          // a stage: A, then B
  constexpr int stage_bytes = L::kStageBytes;
  uint64_t* empty = full + S;
  const int ng = sh.o / sh.groups;
  const int n_tiles = (ng + BN - 1) / BN;
  // M < 2^31 (the wrapper's contract): 32-bit pixel arithmetic
  const int osp = sh.od * sh.oh * sh.ow;
  const int M = static_cast<int>(sh.n * osp);
  const int m_tiles =
      ts.mode == kTiled
          ? ((sh.ow + ts.bw - 1) / ts.bw) * ((sh.oh + ts.bh - 1) / ts.bh) *
                ((sh.od + ts.bd - 1) / ts.bd) *
                static_cast<int>((sh.n + ts.bn - 1) / ts.bn)
          : (M + kBM - 1) / kBM;
  const int cpc = sh.cp / 16;                 // 16-byte chunks a tap
  const int taps = sh.kd * sh.kh * sh.kw;
  const int KC = taps * cpc;
  const int nkb = (taps * sh.cp + kBK - 1) / kBK;
  const int tiles = m_tiles * n_tiles * sh.groups * splits;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      // the copies and the TMA, or the TMAs alone
      mbar_init(&full[s], ts.mode == kGather ? kProducers + 1 : 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ------------------------------------------------------- producer
    const int pt = tid - kConsumers;
    int it = 0;                               // stages issued so far
    if (ts.mode != kGather) {
      if (pt != 0) return;
      const int per_tap = sh.cp / kBK;        // tiled: stages a tap
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile w = tile_of(t, m_tiles, n_tiles, sh.groups, nkb, splits,
                               sh, ts);
        const int wrow = w.g * ng + w.nt * BN;
        for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
          const int s = it % S;
          uint8_t* a_s = sm + s * stage_bytes;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], stage_bytes);
          if (ts.mode == kDense) {
            // the buffer's rows; past Cp, the next group's bytes or zeros
            // meet B's zeros past K
            tma_load_2d(a_s, &tm_a, &full[s], w.g * sh.cp + kb * kBK,
                        w.mt * kBM);
          } else {
            const int tap = kb / per_tap;
            const int kz = tap / (sh.kh * sh.kw);
            const int t2 = tap - kz * sh.kh * sh.kw;
            const int ky = t2 / sh.kw;
            const int kx = t2 - ky * sh.kw;
            tma_load_5d(a_s, &tm_a, &full[s],
                        w.g * sh.cp + (kb - tap * per_tap) * kBK,
                        w.x0 * sh.sw - sh.pw + kx * sh.dw,
                        w.y0 * sh.sh - sh.ph + ky * sh.dh,
                        w.z0 * sh.sd - sh.pd + kz * sh.dd, w.n0);
          }
          tma_load_2d(a_s + a_bytes, &tm_w, &full[s], kb * kBK, wrow);
        }
      }
      return;
    }
    const int c = pt % kChunks;               // the chunk of a row it copies
    const int r0 = pt / kChunks;              // rows r0, r0 + 16, ...
    const int swz = (c ^ (r0 & 7)) << 4;      // 128-byte swizzle of (r, c)
    const long long row_bytes = static_cast<long long>(sh.groups) * sh.cp;
    const uint32_t ring = smem_u32(sm);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile w = tile_of(t, m_tiles, n_tiles, sh.groups, nkb, splits,
                             sh, ts);
      // the rows of the tile: its image (its first pixel in xq, -1 past
      // M) and the first tap's input coordinates
      producers_sync();
      for (int r = pt; r < kBM; r += kProducers) {
        const int m = w.mt * kBM + r;
        int4 ri = make_int4(-1, 0, 0, 0);
        if (m < M) {
          const int nb = m / osp;
          const int sp = m - nb * osp;
          const int ox = sp % sh.ow;
          const int oy = (sp / sh.ow) % sh.oh;
          const int oz = sp / (sh.ow * sh.oh);
          ri = make_int4(nb * sh.id * sh.ih * sh.iw, oz * sh.sd - sh.pd,
                         oy * sh.sh - sh.ph, ox * sh.sw - sh.pw);
        }
        rows[r] = ri;
      }
      producers_sync();
      const int wrow = w.g * ng + w.nt * BN;
      const long long coff0 = static_cast<long long>(w.g) * sh.cp;
      for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
        const int s = it % S;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        if (pt == 0) {
          mbar_expect_tx(&full[s], BN * kBK);
          tma_load_2d(sm + s * stage_bytes + a_bytes, &tm_w, &full[s],
                      kb * kBK, wrow);
        }
        const int kc = kb * kChunks + c;
        const int tap = kc / cpc;
        const int cc = kc - tap * cpc;
        const int kz = tap / (sh.kh * sh.kw);
        const int t2 = tap - kz * sh.kh * sh.kw;
        const int ky = t2 / sh.kw;
        const int kx = t2 - ky * sh.kw;
        const int dz = kz * sh.dd, dy = ky * sh.dh, dx = kx * sh.dw;
        const long long coff = coff0 + 16 * cc;
        const uint32_t dst0 = ring + s * stage_bytes + swz;
#pragma unroll
        for (int j = 0; j < kBM * kChunks / kProducers; ++j) {
          const int r = r0 + kProducers / kChunks * j;
          const int4 ri = rows[r];
          const int z = ri.y + dz, y = ri.z + dy, x = ri.w + dx;
          const bool ok =
              kc < KC && ri.x >= 0 &&
              static_cast<unsigned>(z) < static_cast<unsigned>(sh.id) &&
              static_cast<unsigned>(y) < static_cast<unsigned>(sh.ih) &&
              static_cast<unsigned>(x) < static_cast<unsigned>(sh.iw);
          const int8_t* src =
              ok ? xq + static_cast<long long>(ri.x + (z * sh.ih + y) *
                                                          sh.iw + x) *
                            row_bytes + coff
                 : xq;
          cp_async_16(dst0 + r * kBK, src, ok ? 16u : 0u);
        }
        cp_async_arrive(&full[s]);
      }
    }
    cp_async_wait_all();
  } else {
    // ------------------------------------------------------- consumers
    const int wg = tid / 128;
    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;
    const uint32_t ring = smem_u32(sm);
    int* stage = reinterpret_cast<int*>(sm + L::kStage);
    T* stage_t = reinterpret_cast<T*>(sm + L::kStage);
    const bool has_bias = bias != nullptr;
    const bool gathered = ts.mode == kGather;
    int it = 0;                               // stages consumed so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile w = tile_of(t, m_tiles, n_tiles, sh.groups, nkb, splits,
                             sh, ts);
      const int n0 = w.nt * BN;
      const int cols = min(BN, ng - n0);
      // the tile's epilogue factors, loaded while the products run
      float my_sc = 0.f, my_bi = 0.f;
      if (splits == 1 && tid < cols) {
        my_sc = scale[w.g * ng + n0 + tid];
        if (has_bias) my_bi = bias[w.g * ng + n0 + tid];
      }
      int acc[BN / 2];
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[e] = 0;
      for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
        const int s = it % S;
        const uint32_t a_s = ring + s * stage_bytes;
        mbar_wait(&full[s], (it / S) & 1);
        // cp.async writes through the generic proxy, wgmma reads through
        // the async one (TMA writes through it too)
        if (gathered) fence_proxy_async();
        wgmma_fence();
        const uint64_t a = desc(a_s + wg * 64 * kBK, 16);
        const uint64_t b = desc(a_s + a_bytes, 16);
        static_for<kBK / 32>([&](auto kk) {
          constexpr int k = decltype(kk)::value;
          wgmma_s8<2 * k, 2 * k>(acc, a, b, 1);
        });
        wgmma_commit();
        // the previous stage's products are done: its slot may refill
        wgmma_wait<1>();
        if (kb > w.kb0) mbar_arrive(&empty[(it - 1) % S]);
      }
      wgmma_wait<0>();
      hold(acc);
      if (w.kb1 > w.kb0) mbar_arrive(&empty[(it - 1) % S]);
      // the epilogue, kCols channels at a time: every consumer is past
      // the previous tile's writes before the factors and the staging
      // area are overwritten
      const bool final_out = splits == 1;
      consumers_sync();
      if (final_out && tid < BN) {
        sc[tid] = my_sc;
        bi[tid] = my_bi;
      }
      consumers_sync();
#pragma unroll
      for (int h = 0; h < BN / L::kCols; ++h) {
        if (h > 0) consumers_sync();
#pragma unroll
        for (int j = 0; j < L::kCols / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * j + 2 * (lane % 4) + c;
            const float f = sc[h * L::kCols + col];
            const float b = bi[h * L::kCols + col];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int row = 64 * wg + 16 * warp + lane / 4 + 8 * i;
              const int v = acc[4 * (h * L::kCols / 8 + j) + 2 * i + c];
              if (final_out)
                stage_t[col * kStageRow + row] =
                    from_f32<T>(epilogue(v, f, b, has_bias));
              else
                stage[col * kStageRow + row] = v;
            }
          }
        consumers_sync();
        const int c0 = h * L::kCols;
        if (final_out) {
          T* out_g = out + static_cast<long long>(w.g * ng + n0) * osp;
          if (ts.vec == 4)
            write_chunk<4, L::kCols>(stage_t, tid, w, M, sh, ts, cols, c0,
                                     out_g, osp, true);
          else if (ts.vec == 2)
            write_chunk<2, L::kCols>(stage_t, tid, w, M, sh, ts, cols, c0,
                                     out_g, osp, true);
          else
            write_chunk<1, L::kCols>(stage_t, tid, w, M, sh, ts, cols, c0,
                                     out_g, osp, true);
        } else {
          int* ws_g = ws + static_cast<long long>(w.split) * sh.o * M +
                      static_cast<long long>(w.g * ng + n0) * M;
          if (ts.vec == 4)
            write_chunk<4, L::kCols>(stage, tid, w, M, sh, ts, cols, c0,
                                     ws_g, M, false);
          else if (ts.vec == 2)
            write_chunk<2, L::kCols>(stage, tid, w, M, sh, ts, cols, c0,
                                     ws_g, M, false);
          else
            write_chunk<1, L::kCols>(stage, tid, w, M, sh, ts, cols, c0,
                                     ws_g, M, false);
        }
      }
    }
  }
}

// out = the epilogue of the sum over the splits of ws (S, O, M), a thread
// an (output channel, pixel), pixels fastest.
template <typename T>
__global__ void __launch_bounds__(kEpilogueThreads)
split_epilogue_kernel(const int* __restrict__ ws, int splits, long long M,
                      int O, long long osp, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ out) {
  const long long total = M * O;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int o = static_cast<int>(idx / M);
    const long long m = idx - static_cast<long long>(o) * M;
    int acc = 0;
    for (int s = 0; s < splits; ++s)
      acc += ws[(static_cast<long long>(s) * O + o) * M + m];
    const long long nb = m / osp;
    out[(nb * O + o) * osp + (m - nb * osp)] = from_f32<T>(
        epilogue(acc, scale[o], bias != nullptr ? bias[o] : 0.f,
                 bias != nullptr));
  }
}

template <int BN, typename T>
int launch(const void* xq, const void* w, const void* scale, const void* bias,
           void* out, void* ws, const ConvShape& sh, TileShape ts, int splits,
           cudaStream_t stream) {
  using L = Smem<BN>;
  const int taps = sh.kd * sh.kh * sh.kw;
  const long long M = sh.n * sh.od * sh.oh * sh.ow;
  const long long osp = static_cast<long long>(sh.od) * sh.oh * sh.ow;
  const long long K = static_cast<long long>(taps) * sh.cp;
  const long long row = static_cast<long long>(sh.groups) * sh.cp;
  const int ng = sh.o / sh.groups;
  bool ok = true;
  long long m_tiles = (M + kBM - 1) / kBM;
  if (ts.mode == kDense)
    ok = ok && taps == 1 && sh.sd == 1 && sh.sh == 1 && sh.sw == 1 &&
         sh.pd == 0 && sh.ph == 0 && sh.pw == 0;
  if (ts.mode == kTiled) {
    ok = ok && sh.cp % kBK == 0 && ts.bw > 0 && ts.bh > 0 && ts.bd > 0 &&
         ts.bn > 0 && ts.bw * ts.bh * ts.bd * ts.bn == kBM &&
         ts.bw * sh.sw <= 256 && ts.bh * sh.sh <= 256 &&
         ts.bd * sh.sd <= 256 && sh.sw <= 8 && sh.sh <= 8 && sh.sd <= 8;
    if (ok)
      m_tiles = static_cast<long long>((sh.ow + ts.bw - 1) / ts.bw) *
                ((sh.oh + ts.bh - 1) / ts.bh) *
                ((sh.od + ts.bd - 1) / ts.bd) * ((sh.n + ts.bn - 1) / ts.bn);
  }
  const long long tiles = m_tiles * ((ng + BN - 1) / BN) * sh.groups * splits;
  const int nkb = static_cast<int>((K + kBK - 1) / kBK);
  if (!ok || (ts.mode != kGather && ts.mode != kDense &&
              ts.mode != kTiled) ||
      M >= 0x7fffffffLL || tiles >= 0x7fffffffLL || splits < 1 ||
      splits > nkb || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // pixels a thread writes at once: the widest of 4, 2, 1 that keeps
  // them in one image (tiled: in one row of the box and of the output)
  ts.vec = 1;
  for (int v = 4; v > 1 && ts.vec == 1; v /= 2)
    if (ts.mode == kTiled ? sh.ow % v == 0 && ts.bw % v == 0 : osp % v == 0)
      ts.vec = v;
  // B: the packed weights (O, K); A: the buffer's rows (M, G Cp), or the
  // buffer as (G Cp, W, H, D, N) boxes of one tap at the strides
  CUtensorMap tm_w, tm_a;
  const long long wd[2] = {K, sh.o};
  const int wbox[2] = {kBK, BN}, ones[5] = {1, 1, 1, 1, 1};
  int err = tensor_map_s8(&tm_w, w, 2, wd, wd, wbox, ones);
  if (!err && ts.mode == kDense) {
    const long long ad[2] = {row, M};
    const int abox[2] = {128, kBM};
    err = tensor_map_s8(&tm_a, xq, 2, ad, ad, abox, ones);
  } else if (!err && ts.mode == kTiled) {
    const long long ad[5] = {row, sh.iw, sh.ih, sh.id, sh.n};
    const long long as[4] = {row, row * sh.iw, row * sh.iw * sh.ih,
                             row * sh.iw * sh.ih * sh.id};
    const int abox[5] = {kBK, ts.bw * sh.sw, ts.bh * sh.sh, ts.bd * sh.sd,
                         ts.bn};
    const int aes[5] = {1, sh.sw, sh.sh, sh.sd, 1};
    err = tensor_map_s8(&tm_a, xq, 5, ad, as, abox, aes);
  } else {
    tm_a = tm_w;
  }
  if (err) return err;
  const int smem = L::kBytes + 1024;
  e = cudaFuncSetAttribute(conv_kernel<BN, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  conv_kernel<BN, T><<<grid, kThreads, smem, stream>>>(
      tm_w, tm_a, static_cast<const int8_t*>(xq),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<int*>(ws), sh, ts, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long long total = M * sh.o;
  const long long blocks = (total + kEpilogueThreads - 1) / kEpilogueThreads;
  split_epilogue_kernel<T><<<static_cast<unsigned>(blocks < 4096 ? blocks
                                                                 : 4096),
                             kEpilogueThreads, 0, stream>>>(
      static_cast<const int*>(ws), splits, M, sh.o, osp,
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bn(int bn, const void* xq, const void* w, const void* scale,
              const void* bias, void* out, void* ws, const ConvShape& sh,
              const TileShape& ts, int splits, cudaStream_t stream) {
  switch (bn) {
    case 64:
      return launch<64, T>(xq, w, scale, bias, out, ws, sh, ts, splits,
                           stream);
    case 128:
      return launch<128, T>(xq, w, scale, bias, out, ws, sh, ts, splits,
                            stream);
    case 256:
      return launch<256, T>(xq, w, scale, bias, out, ws, sh, ts, splits,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc
}  // namespace

// xq: (n, id, ih, iw, groups, cp) int8 from mx_int8_quantize_cl, 16-byte
// aligned; w: (groups, o / groups, kd * kh * kw, cp) int8, 16-byte aligned
// (pack_weight); scale: (o,) float32, act_scale * w_scale; bias: (o,)
// float32 or null; out: (n, o, od, oh, ow) of dtype (0 float32, 1
// bfloat16); ws: (splits, o, n * od * oh * ow) int32 when splits > 1, else
// unused.  dims: the 22 ints n, o, groups, cp, id, ih, iw, od, oh, ow, kd,
// kh, kw, sd, sh, sw, pd, ph, pw, dd, dh, dw; tile: the 5 ints mode (0
// gather, 1 dense, 2 tiled: cp a multiple of 128) and the tiled box bw,
// bh, bd, bn (product 128); bn: output channels a block (64, 128 or 256);
// splits: blocks over K, 1 to ceil(taps * cp / 128).  Launches on
// `stream` and returns cudaGetLastError() after the launches.
extern "C" int mx_int8_conv(const void* xq, const void* w, const void* scale,
                            const void* bias, void* out, void* ws,
                            const long long* dims, const long long* tile,
                            int bn, int splits, int dtype, void* stream) {
  int d[22];
  for (int i = 1; i < 22; ++i) d[i] = static_cast<int>(dims[i]);
  const tc::ConvShape sh{dims[0], d[1],  d[2],  d[3],  d[4],  d[5],  d[6],
                         d[7],    d[8],  d[9],  d[10], d[11], d[12], d[13],
                         d[14],   d[15], d[16], d[17], d[18], d[19], d[20],
                         d[21]};
  const tc::TileShape ts{static_cast<int>(tile[0]), static_cast<int>(tile[1]),
                         static_cast<int>(tile[2]), static_cast<int>(tile[3]),
                         static_cast<int>(tile[4]), 1};
  if (sh.groups <= 0 || sh.o % sh.groups || sh.cp % 16 || sh.cp <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (sh.n * sh.od * sh.oh * sh.ow <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return tc::launch_bn<float>(bn, xq, w, scale, bias, out, ws, sh, ts,
                                  splits, s);
    case 1:
      return tc::launch_bn<__nv_bfloat16>(bn, xq, w, scale, bias, out, ws,
                                          sh, ts, splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
