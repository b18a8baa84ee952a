// Dropout for sm_90a: the keep-mask, and the masked apply with the
// residual add fused into the same pass, forward and backward.
//
// Replaces the Pallas TPU kernel `_dropout_kernel` launched by `_kernel2d`
// (incubator_mxnet_tpu/ops/dropout_kernel.py:250).  The TPU kernel writes
// only the uint8 keep-mask, because on XLA the apply
// `where(mask, x * scale, 0) [+ res]` fuses into the producer and consumer
// fusions around it.  Eager PyTorch has no such fusion: there the apply is
// a multiply, a select and an add, three passes over the activations
// forward and two more backward.  So here the fusion XLA gave the JAX
// package is written out: one pass draws the bits, writes the mask and
// writes y = [res +] where(keep, x * scale, 0); one pass backward reads the
// saved mask and writes dx = where(mask, dy, 0) * scale.
//
// Mask contract (unchanged from the first port of this kernel): element i
// of the flattened array is kept iff word i % 4 of Philox4x32-10 (Salmon et
// al., SC'11; the Random123 constants) with counter (i / 4 low word, high
// word, 0, 0) and the 64-bit seed as key is >= thresh, where
// thresh = min(int(rate * 2^32), 2^32 - 1).  The mask is a pure function of
// (seed, numel, rate): no launch geometry enters it, so the plain PyTorch
// version (`mask_reference`) computes the same bits with integer tensor ops.
//
// Design.  Each thread takes 8 consecutive elements a step: it draws two
// Philox blocks, stores their mask as one 8-byte word and loads and stores
// x, res, y, dy and dx as 16-byte vectors (one a bf16 operand, two an f32
// one); a grid-stride loop walks the array over a grid of as many blocks as
// fit on the card at once.  Eight elements a step, not sixteen: timed on
// an H100 at the BERT sites' (4096, 1024) bf16, the two were as fast from
// a cold L2 and eight a step was faster from a warm one (where a layer's
// output still sits), with fewer registers; one step a thread (a grid of
// n / 2048 blocks) and a cap of 32 registers were no faster.  The ten
// round keys are the same for every thread, so the host computes them and
// they reach the kernel as parameters (constant-bank operands, no
// per-element adds); the first round's zero counter words fold away.  A
// ragged last chunk, and any launch whose operands are not all 16-byte
// aligned, take a scalar path of the same kernel with the same bits.
//
// Seeds in device memory (the `_dev` entries).  A captured CUDA graph
// replays its launch parameters as they were at capture, so a seed passed
// by value would give every replay one mask.  The `_dev` entries take a
// pointer to the int64 seed instead (a slot of the seed table that a
// captured program stages before each replay, as the JAX kernel reads its
// seed from SMEM): each thread loads it once, one address for the whole
// grid, and derives the ten round keys in registers before its loop.  The
// counter, the keys and the threshold are those of the by-value entries,
// so a seed gives the same bits through either.  Eager calls outside a
// program keep the by-value entries and copy nothing to the card.
//
// Bit-identical to the torch composition (the plain version): the product
// x * scale is taken in f32 and rounded to the element type once, then the
// residual is added in f32 and the sum rounded again; __fmul_rn/__fadd_rn
// keep nvcc from contracting the two into one FMA.  A dropped element is
// a select, not a multiply by the mask, so a NaN or Inf there gives 0, and
// res + 0 is still added (a -0.0 residual gives +0.0, as in torch).
// A bf16 x with an f32 residual (the bf16 Transformer's residual stream,
// which the JAX package's f32 positional table promotes) rounds the
// product to bf16 and adds it to the residual in f32, writing f32: the
// JAX package's `res + where(mask, x * scale, 0)` under type promotion.
//
// Bounds on the H100 (n elements, e bytes an element):
//   mask:     the larger of n bytes written over 3.35 TB/s and 38 integer
//             multiplies per 4 elements (Philox4x32-10's 40, less the two
//             of the first round's zero counter words) at 64 a clock an SM
//             (the CUDA guide's rate for compute capability 9.0), 132 SMs;
//             at 1.98 GHz the multiplies bound it;
//   forward:  bytes: x (and res) read, y and the mask written, n (3e + 1)
//             or n (2e + 1);
//   backward: bytes: dy and the mask read, dx written, n (2e + 1).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;              // elements a thread takes a step
constexpr int kBlocks = kChunk / 4;    // Philox blocks a step
using MaskWord = uint2;                // the chunk's mask, one 8-byte word
constexpr uint32_t kM0 = 0xD2511F53u;  // Philox4x32 multipliers
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;  // Weyl key increments
constexpr uint32_t kW1 = 0xBB67AE85u;

enum Mode { kMaskOnly, kForward, kForwardRes, kBackward };

struct RoundKeys {
  uint32_t k0[10];
  uint32_t k1[10];
};

__host__ __device__ inline RoundKeys round_keys(unsigned long long seed) {
  RoundKeys rk;
  uint32_t k0 = static_cast<uint32_t>(seed);
  uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  for (int r = 0; r < 10; ++r) {
    rk.k0[r] = k0;
    rk.k1[r] = k1;
    k0 += kW0;
    k1 += kW1;
  }
  return rk;
}

// Philox4x32-10 of counter (ctr low, ctr high, 0, 0).
__device__ __forceinline__ uint4 philox(uint64_t ctr, const RoundKeys& rk) {
  uint32_t c0 = static_cast<uint32_t>(ctr);
  uint32_t c1 = static_cast<uint32_t>(ctr >> 32);
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = kM0 * c0;
    const uint32_t hi0 = __umulhi(kM0, c0);
    const uint32_t lo1 = kM1 * c2;
    const uint32_t hi1 = __umulhi(kM1, c2);
    c0 = hi1 ^ c1 ^ rk.k0[r];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ rk.k1[r];
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The four keep bytes (0 or 1) of one Philox block, little-endian.
__device__ __forceinline__ uint32_t keep_bytes(uint4 r, uint32_t thresh) {
  return static_cast<uint32_t>(r.x >= thresh) |
         static_cast<uint32_t>(r.y >= thresh) << 8 |
         static_cast<uint32_t>(r.z >= thresh) << 16 |
         static_cast<uint32_t>(r.w >= thresh) << 24;
}

__device__ __forceinline__ bool kept(const uint32_t (&keep)[kBlocks], int i) {
  return (keep[i >> 2] >> (8 * (i & 3))) & 0xffu;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// One element of the output: the forward's [res +] where(keep, x*s, 0),
// the backward's where(keep, dy, 0) * s; each product rounded to T (the
// input's type) once, the sum with the residual to O (the residual's and
// the output's type).
template <typename T, typename O, int M>
__device__ __forceinline__ O apply(bool keep, T in, O res, float scale) {
  const float p = keep ? to_f32(from_f32<T>(__fmul_rn(to_f32(in), scale)))
                       : 0.0f;
  if constexpr (M == kForwardRes) {
    return from_f32<O>(__fadd_rn(to_f32(res), p));
  } else {
    return from_f32<O>(p);
  }
}

// in: x (forward) or dy (backward), of type T; res: the residual
// (kForwardRes) and out: y or dx, of type O (T, or f32 residual and output
// for a bf16 x: the JAX package's bf16 sublayer output added to an f32
// residual stream); mask: written (the forward modes) or read (kBackward).
// vec: every operand is 16-byte aligned.  kDevSeed: the round keys come
// from the seed at `seed` in device memory, not from `rk`.
template <typename T, typename O, int M, bool kDevSeed>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ in, const O* __restrict__ res,
               O* __restrict__ out, uint8_t* __restrict__ mask, int64_t n,
               RoundKeys rk, const unsigned long long* __restrict__ seed,
               uint32_t thresh, float scale, bool vec) {
  if constexpr (kDevSeed) rk = round_keys(*seed);
  constexpr int kVecs = kChunk * sizeof(T) / 16;   // 16-byte words of in
  constexpr int kOVecs = kChunk * sizeof(O) / 16;  // and of res and out
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       c < chunks; c += stride) {
    const int64_t base = c * kChunk;
    const bool full = vec && base + kChunk <= n;
    uint32_t keep[kBlocks];
    if constexpr (M == kBackward) {
      if (full) {
        const MaskWord m = *reinterpret_cast<const MaskWord*>(mask + base);
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&m);
#pragma unroll
        for (int k = 0; k < kBlocks; ++k) keep[k] = w[k];
      } else {
#pragma unroll
        for (int k = 0; k < kBlocks; ++k) keep[k] = 0u;
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          if (base + i < n)
            keep[i >> 2] |= static_cast<uint32_t>(mask[base + i] != 0)
                            << (8 * (i & 3));
      }
    } else {
#pragma unroll
      for (int k = 0; k < kBlocks; ++k)
        keep[k] = keep_bytes(
            philox(static_cast<uint64_t>(kBlocks * c + k), rk), thresh);
      if (full) {
        MaskWord m;
        uint32_t* w = reinterpret_cast<uint32_t*>(&m);
#pragma unroll
        for (int k = 0; k < kBlocks; ++k) w[k] = keep[k];
        *reinterpret_cast<MaskWord*>(mask + base) = m;
      } else {
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          if (base + i < n) mask[base + i] = static_cast<uint8_t>(kept(keep, i));
      }
    }
    if constexpr (M != kMaskOnly) {
      if (full) {
        uint4 a[kVecs], b[kOVecs];
#pragma unroll
        for (int v = 0; v < kVecs; ++v)
          a[v] = reinterpret_cast<const uint4*>(in + base)[v];
        if constexpr (M == kForwardRes) {
#pragma unroll
          for (int v = 0; v < kOVecs; ++v)
            b[v] = reinterpret_cast<const uint4*>(res + base)[v];
        }
        const T* xa = reinterpret_cast<const T*>(a);
        const O* ra = reinterpret_cast<const O*>(b);
        uint4 o[kOVecs];
        O* oa = reinterpret_cast<O*>(o);
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          oa[i] = apply<T, O, M>(kept(keep, i), xa[i],
                                 M == kForwardRes ? ra[i] : O(), scale);
#pragma unroll
        for (int v = 0; v < kOVecs; ++v)
          reinterpret_cast<uint4*>(out + base)[v] = o[v];
      } else {
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          if (base + i < n)
            out[base + i] = apply<T, O, M>(
                kept(keep, i), in[base + i],
                M == kForwardRes ? res[base + i] : O(), scale);
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launch over a grid of as many blocks as the card holds at once (every
// SM full), fewer when the array is small.
template <typename T, typename O, int M, bool kDevSeed = false>
int launch(const void* in, const void* res, void* out, void* mask,
           long long n, const RoundKeys& rk, const void* seed,
           uint32_t thresh, float scale, void* stream) {
  if (n <= 0) return 0;
  static int resident = 0;  // blocks an SM, per instantiation
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && resident == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, dropout_kernel<T, O, M, kDevSeed>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long chunks = (n + kChunk - 1) / kChunk;
  const long long need = (chunks + kThreads - 1) / kThreads;
  const long long room =
      static_cast<long long>(sms) * (resident > 0 ? resident : 1);
  const unsigned blocks = static_cast<unsigned>(need < room ? need : room);
  const bool vec = aligned16(in) && aligned16(res) && aligned16(out) &&
                   aligned16(mask);
  dropout_kernel<T, O, M, kDevSeed><<<blocks, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<const O*>(res),
      static_cast<O*>(out), static_cast<uint8_t*>(mask), n, rk,
      static_cast<const unsigned long long*>(seed), thresh, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int M, bool kDevSeed = false>
int launch_typed(int dtype, const void* in, const void* res, void* out,
                 void* mask, long long n, const RoundKeys& rk,
                 const void* seed, uint32_t thresh, float scale,
                 void* stream) {
  switch (dtype) {
    case 0:
      return launch<float, float, M, kDevSeed>(in, res, out, mask, n, rk,
                                               seed, thresh, scale, stream);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16, M, kDevSeed>(
          in, res, out, mask, n, rk, seed, thresh, scale, stream);
    case 2:  // a bf16 x, an f32 residual and output: the forward with res
      if constexpr (M == kForwardRes)
        return launch<__nv_bfloat16, float, M, kDevSeed>(
            in, res, out, mask, n, rk, seed, thresh, scale, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Every entry launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() after the launch.  seed: the 64-bit Philox key (low
// word first), by value or (the `_dev` entries) as a pointer to it in
// device memory, 8-byte aligned; thresh: keep iff word >= thresh; scale:
// 1 / (1 - rate) rounded to x's type; dtype: 0 float32, 1 bfloat16,
// 2 (the forward with a residual only) a bfloat16 x with a float32
// residual and y.  Any pointer alignment of the operands is taken (16-byte
// aligned operands take the vector path).

// The keep-mask alone: mask uint8 (n,).
extern "C" int mx_dropout_mask(void* mask, long long n, unsigned long long seed,
                               unsigned int thresh, void* stream) {
  return launch<float, float, kMaskOnly>(nullptr, nullptr, nullptr, mask, n,
                                  round_keys(seed), nullptr, thresh, 0.0f,
                                  stream);
}

// mx_dropout_mask with the seed read from device memory.
extern "C" int mx_dropout_mask_dev(void* mask, long long n, const void* seed,
                                   unsigned int thresh, void* stream) {
  return launch<float, float, kMaskOnly, true>(nullptr, nullptr, nullptr,
                                               mask, n, RoundKeys{}, seed,
                                               thresh, 0.0f, stream);
}

// Forward: reads x (n,) and res (n,) unless it is null; writes the mask
// (n,) uint8 and y = [res +] where(keep, x * scale, 0) (n,).
extern "C" int mx_dropout_fwd(const void* x, const void* res, void* y,
                              void* mask, long long n, unsigned long long seed,
                              unsigned int thresh, float scale, int dtype,
                              void* stream) {
  const RoundKeys rk = round_keys(seed);
  if (res == nullptr)
    return launch_typed<kForward>(dtype, x, nullptr, y, mask, n, rk, nullptr,
                                  thresh, scale, stream);
  return launch_typed<kForwardRes>(dtype, x, res, y, mask, n, rk, nullptr,
                                   thresh, scale, stream);
}

// mx_dropout_fwd with the seed read from device memory.
extern "C" int mx_dropout_fwd_dev(const void* x, const void* res, void* y,
                                  void* mask, long long n, const void* seed,
                                  unsigned int thresh, float scale, int dtype,
                                  void* stream) {
  if (res == nullptr)
    return launch_typed<kForward, true>(dtype, x, nullptr, y, mask, n,
                                        RoundKeys{}, seed, thresh, scale,
                                        stream);
  return launch_typed<kForwardRes, true>(dtype, x, res, y, mask, n,
                                         RoundKeys{}, seed, thresh, scale,
                                         stream);
}

// Backward: reads dy (n,) and the saved mask (n,); writes
// dx = where(mask, dy, 0) * scale (n,).
extern "C" int mx_dropout_bwd(const void* dy, const void* mask, void* dx,
                              long long n, float scale, int dtype,
                              void* stream) {
  return launch_typed<kBackward>(dtype, dy, nullptr, dx,
                                 const_cast<void*>(mask), n, RoundKeys{},
                                 nullptr, 0u, scale, stream);
}
