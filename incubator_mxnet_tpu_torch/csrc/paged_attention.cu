// Single-query paged attention over the serving KV pool, for sm_90a.
//
// Replaces the Pallas TPU kernel `_paged_kernel`, both as `_paged_core`
// launches it (float pages) and as `_paged_core_q8` does (int8 pages with an
// f32 scale per (block, head, slot); incubator_mxnet_tpu/ops/
// paged_attention.py).  One template covers both page types.
//
// One block of kWarps = 8 warps per (lane, head).  Warp w walks pages w,
// w + 8, w + 16, ... of pages 0 .. pos/bs of its lane, reading each page id
// from the lane's block-table row itself (the TPU's scalar prefetch has no
// counterpart here), and keeps its own online softmax (m, l, acc) in
// registers:
//
// * the lanes of a warp split a slot row into 16-byte vectors (kTpr lanes a
//   row: 8 for bf16 pages at D = 64, 4 for int8, 16 for f32) and cover 32 /
//   kTpr rows a pass; each lane owns the same kVec head columns of every
//   row it visits and holds q's values there in registers;
// * a unit of up to four passes loads its K and its V rows with 16-byte
//   vector loads straight to registers, both before any math, so the two
//   loads are in flight together; an int8 slot's scale is loaded with it;
// * a slot's score is the lane's partial dot (int8 pages dequantized first,
//   f32(page) * scale, as the TPU's `_dequant`), summed over the row's
//   lanes with shuffles, then / sqrt(D); the unit's max over its rows comes
//   from shuffles across the row groups; acc and l are rescaled by
//   alpha = exp(m_old - m_new) and take p * v;
// * at the end each warp sums its row groups' parts with shuffles, and the
//   eight warps' (m, l, acc) are merged in shared memory in a fixed order
//   (warp 0, 1, ...) with the update of `_paged_kernel`: M = max m_w, l =
//   sum exp(m_w - M) l_w, out = sum exp(m_w - M) acc_w / l.
//
// Bound on the H100: bytes.  A decode step reads every live page of every
// lane once (2 * pages * bs * D * sizeof(page), plus 4 bytes a slot of
// scale for int8 pages) and does ~4 flops per page byte, far below the
// card's ~295 flop/byte ridge; at the serving engine's busiest step that is
// 0.0015 ms of bf16 pages or 0.0008 ms of int8, so latency, not bytes,
// sets the time: a lane's pages walked one after another would leave one
// page's loads in flight a block and a load round trip a page.  Split over
// eight warps, a lane of ~21 pages is ~3 pages a warp, each a few 16-byte
// loads a thread issued together, and a block's warps keep eight pages'
// loads in flight at once.  There is no second pass: the merge runs in the
// same launch (a split of a lane across blocks would need a second kernel
// or atomics, and the serving step is already host-bound at 12 launches an
// iteration).
//
// The eviction contract of the serving engine holds inside this kernel:
// a block touches only its own lane's table row, pages and output; masked
// slots (past pos) are never loaded, neither page bytes nor scales, and
// contribute exactly 0.0; a warp without a page merges as an exact no-op
// (m = -FLT_MAX, finfo(f32).min as the TPU kernel initialises, l = 0, acc
// = 0: its weight exp(m - M) is 0); pos < 0 gives 0.  There are no atomics,
// and which warp takes which page, and every sum's order, depend only on
// the lane's own pos and the constants, so the same inputs give bitwise-
// equal output whichever other lanes share the batch.
#include <cfloat>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBs = 64;
constexpr int kMaxD = 128;
constexpr int kPasses = 4;   // slot-row passes of one online-softmax unit

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

// 16 bytes of page elements: kVec of them, widened to f32.
template <typename P> struct Vec16;

template <> struct Vec16<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* x) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
};

template <> struct Vec16<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* x) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 b;
      *reinterpret_cast<uint32_t*>(&b) = w[i];
      const float2 f = __bfloat1622float2(b);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

template <> struct Vec16<int8_t> {
  static constexpr int kVec = 16;
  __device__ __forceinline__ static void unpack(const uint4& u, float* x) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = static_cast<float>(
          static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// T: q and output type (f32 or bf16); P: page type (T, or int8 with f32
// scales (num_blocks, H, bs) in scale_k / scale_v, null for float pages);
// D: the head dim.
template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const P* __restrict__ pool_k,
                       const P* __restrict__ pool_v,
                       const float* __restrict__ scale_k,
                       const float* __restrict__ scale_v,
                       const int32_t* __restrict__ tables,
                       const int32_t* __restrict__ pos, T* __restrict__ out,
                       int H, int bs, int nbps, float sqrt_d) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int kVec = Vec16<P>::kVec;
  static_assert(D <= kMaxD && D % kVec == 0 && D / kVec <= 32, "head dim");
  constexpr int kTpr = D / kVec;      // lanes a slot row
  constexpr int kRpw = 32 / kTpr;     // slot rows a pass
  constexpr int kUnit = kRpw * kPasses;
  __shared__ float m_s[kWarps];
  __shared__ float l_s[kWarps];
  __shared__ float acc_s[kWarps][D];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / kTpr;           // the lane's row of a pass
  const int col = (lane % kTpr) * kVec;  // its first head column
  const int t = pos[b];
  const int npages = t < 0 ? 0 : min(t / bs, nbps - 1) + 1;
  const size_t row = (static_cast<size_t>(b) * H + h) * D;

  float qv[kVec];
#pragma unroll
  for (int x = 0; x < kVec; ++x) qv[x] = to_f32(q[row + col + x]);

  float m = -FLT_MAX;  // running max, finfo(f32).min like the TPU kernel
  float l = 0.f;       // this lane's part of the denominator
  float acc[kVec];     // and of the output's kVec columns
#pragma unroll
  for (int x = 0; x < kVec; ++x) acc[x] = 0.f;
  for (int j = warp; j < npages; j += kWarps) {
    // (block, head) of this page: its slots' first scale, then its values
    const size_t slot0 =
        (static_cast<size_t>(tables[static_cast<size_t>(b) * nbps + j]) * H +
         h) * static_cast<size_t>(bs);
    const P* kp = pool_k + slot0 * D + col;
    const P* vp = pool_v + slot0 * D + col;
    const int live = min(bs, t - j * bs + 1);  // rows 0 .. live-1 are <= t
    for (int u = 0; u < live; u += kUnit) {
      // passes of this unit that hold a live row (the same for the whole
      // warp: passes past them are skipped, not masked)
      const int passes = min(kPasses, (live - u + kRpw - 1) / kRpw);
      uint4 kr[kPasses], vr[kPasses];
      float sk[kPasses], sv[kPasses];
      bool ok[kPasses];
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int r = u + p * kRpw + grp;
        ok[p] = p < passes && r < live;
        kr[p] = vr[p] = make_uint4(0u, 0u, 0u, 0u);
        sk[p] = sv[p] = 0.f;
        if (ok[p]) {  // a masked slot's bytes and scale are never loaded
          kr[p] = load16(kp + static_cast<size_t>(r) * D);
          vr[p] = load16(vp + static_cast<size_t>(r) * D);
          if constexpr (kQuant) {
            sk[p] = __ldg(scale_k + slot0 + r);
            sv[p] = __ldg(scale_v + slot0 + r);
          }
        }
      }
      float s[kPasses];
      float mx = -FLT_MAX;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        s[p] = -FLT_MAX;
        if (p >= passes) continue;
        float x[kVec];
        Vec16<P>::unpack(kr[p], x);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float kx = kQuant ? x[e] * sk[p] : x[e];  // dequantize first
          dot = fmaf(kx, qv[e], dot);
        }
#pragma unroll
        for (int off = kTpr / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        // scaled after the dot, as the TPU kernel does
        s[p] = ok[p] ? dot / sqrt_d : -FLT_MAX;
        mx = fmaxf(mx, s[p]);
      }
#pragma unroll
      for (int off = kTpr; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int x = 0; x < kVec; ++x) acc[x] *= alpha;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        if (!ok[p]) continue;
        const float pp = expf(s[p] - m_new);
        l += pp;
        float x[kVec];
        Vec16<P>::unpack(vr[p], x);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[e] = fmaf(pp, kQuant ? x[e] * sv[p] : x[e], acc[e]);
      }
      m = m_new;
    }
  }
  // the warp's (l, acc): its row groups' parts summed (every lane of a
  // row group holds the same l)
#pragma unroll
  for (int off = kTpr; off < 32; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int x = 0; x < kVec; ++x)
      acc[x] += __shfl_xor_sync(0xffffffffu, acc[x], off);
  }
  if (lane < kTpr) {
#pragma unroll
    for (int x = 0; x < kVec; ++x) acc_s[warp][col + x] = acc[x];
    if (lane == 0) {
      m_s[warp] = m;
      l_s[warp] = l;
    }
  }
  __syncthreads();
  // the fixed-order merge of the warps' partials
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float mm = -FLT_MAX;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_s[w]);
    float ll = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(m_s[w] - mm);
      ll = fmaf(a, l_s[w], ll);
      o = fmaf(a, acc_s[w][d], o);
    }
    out[row + d] = from_f32<T>(ll > 0.f ? o / ll : 0.f);
  }
}

template <typename T, typename P, int D>
void launch_d(const void* q, const void* pool_k, const void* pool_v,
              const void* scale_k, const void* scale_v, const void* tables,
              const void* pos, void* out, int B, int H, int bs, int nbps,
              cudaStream_t stream) {
  dim3 grid(B, H);
  paged_attention_kernel<T, P, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pool_k),
      static_cast<const P*>(pool_v), static_cast<const float*>(scale_k),
      static_cast<const float*>(scale_v), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(pos), static_cast<T*>(out), H, bs, nbps,
      sqrtf(static_cast<float>(D)));
}

template <typename T, typename P>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* scale_k, const void* scale_v, const void* tables,
           const void* pos, void* out, int B, int H, int D, int bs, int nbps,
           cudaStream_t stream) {
  // the 16-byte row loads need 16-byte aligned pools
  if (reinterpret_cast<uintptr_t>(pool_k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(pool_v) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (D) {
    case 16:
      launch_d<T, P, 16>(q, pool_k, pool_v, scale_k, scale_v, tables, pos,
                         out, B, H, bs, nbps, stream);
      break;
    case 32:
      launch_d<T, P, 32>(q, pool_k, pool_v, scale_k, scale_v, tables, pos,
                         out, B, H, bs, nbps, stream);
      break;
    case 64:
      launch_d<T, P, 64>(q, pool_k, pool_v, scale_k, scale_v, tables, pos,
                         out, B, H, bs, nbps, stream);
      break;
    case 128:
      launch_d<T, P, 128>(q, pool_k, pool_v, scale_k, scale_v, tables, pos,
                          out, B, H, bs, nbps, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int D, int bs) {
  return (D == 16 || D == 32 || D == 64 || D == 128) && bs >= 1 &&
         bs <= kMaxBs;
}

template <typename T, typename P>
const void* kernel_of(int D) {
  switch (D) {
    case 16: return reinterpret_cast<const void*>(paged_attention_kernel<T, P, 16>);
    case 32: return reinterpret_cast<const void*>(paged_attention_kernel<T, P, 32>);
    case 64: return reinterpret_cast<const void*>(paged_attention_kernel<T, P, 64>);
    case 128: return reinterpret_cast<const void*>(paged_attention_kernel<T, P, 128>);
    default: return nullptr;
  }
}

}  // namespace

// What the kernel instantiated for (dtype, page type, D) uses: registers a
// thread, local (spill) bytes, static shared memory bytes, and how many of
// its blocks an SM holds.  dtype as below; quant 1 for int8 pages.
extern "C" int mx_paged_attention_info(int dtype, int quant, int D, int* regs,
                                       int* local_bytes, int* smem,
                                       int* blocks_per_sm) {
  const void* fn = nullptr;
  if (dtype == 0)
    fn = quant ? kernel_of<float, int8_t>(D) : kernel_of<float, float>(D);
  else if (dtype == 1)
    fn = quant ? kernel_of<__nv_bfloat16, int8_t>(D)
               : kernel_of<__nv_bfloat16, __nv_bfloat16>(D);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, kThreads, 0));
}

// dtype: 0 = float32, 1 = bfloat16.  q, out (B, H, D); pools
// (num_blocks, H, bs, D) in q's dtype, 16-byte aligned; tables (B, nbps)
// int32; pos (B,) int32; all contiguous on one device.  D in {16, 32, 64,
// 128}, 1 <= bs <= 64 (the wrapper checks).  Returns cudaGetLastError()
// after the launch.
extern "C" int mx_paged_attention(int dtype, const void* q, const void* pool_k,
                                  const void* pool_v, const void* tables,
                                  const void* pos, void* out, int B, int H,
                                  int D, int bs, int nbps, void* stream) {
  if (!shape_ok(D, bs)) return static_cast<int>(cudaErrorInvalidValue);
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

// The int8-page variant: pools (num_blocks, H, bs, D) int8, 16-byte
// aligned, scale_k and scale_v (num_blocks, H, bs) float32; q and out f32
// (dtype 0) or bf16 (dtype 1); the rest as mx_paged_attention.
extern "C" int mx_paged_attention_q8(int dtype, const void* q,
                                     const void* pool_k, const void* pool_v,
                                     const void* scale_k, const void* scale_v,
                                     const void* tables, const void* pos,
                                     void* out, int B, int H, int D, int bs,
                                     int nbps, void* stream) {
  if (!shape_ok(D, bs) || scale_k == nullptr || scale_v == nullptr)
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
