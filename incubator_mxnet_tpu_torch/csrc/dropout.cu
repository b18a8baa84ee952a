// Dropout keep-mask for sm_90a.
//
// Replaces the Pallas TPU kernel `_dropout_kernel` launched by `_kernel2d`
// (incubator_mxnet_tpu/ops/dropout_kernel.py).  As there, the kernel writes
// only the uint8 keep-mask; the apply (where(mask, x * scale, 0), plus the
// residual) stays in torch ops around it, and the backward reuses the saved
// mask, so the kernel runs in the forward only.
//
// The TPU kernel drew its bits from the core's own PRNG, seeded per mask
// tile.  Here every thread runs one Philox4x32-10 (Salmon et al., SC'11;
// the Random123 constants) keyed by the 64-bit seed, with the counter set to
// its thread index t = element index / 4, and writes the 4 mask bytes of
// elements 4t .. 4t+3: byte i is 1 iff word i >= thresh, where
// thresh = min(int(rate * 2^32), 2^32 - 1).  The mask is therefore a pure
// function of (seed, numel, rate): no launch geometry enters it, so any
// split of the array (tile-aligned shards included) gives the same global
// mask, and the plain PyTorch version (`mask_reference`) computes the same
// bits with integer tensor ops.
//
// Bound on the H100: bytes.  The kernel reads nothing and writes one byte
// per element; ten Philox rounds cost ~50 integer instructions per 4 bytes,
// far below the card's integer rate at 3.35 TB/s of stores.  Each thread
// stores its 4 bytes as one aligned 32-bit word (the output is a fresh
// allocation, so element 4t sits on a 4-byte boundary); a partial last word
// is written byte by byte.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kM0 = 0xD2511F53u;  // Philox4x32 multipliers
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;  // Weyl key increments
constexpr uint32_t kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kW0;
      k.y += kW1;
    }
    const uint32_t lo0 = kM0 * c.x;
    const uint32_t hi0 = __umulhi(kM0, c.x);
    const uint32_t lo1 = kM1 * c.z;
    const uint32_t hi1 = __umulhi(kM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
dropout_mask_kernel(uint8_t* __restrict__ mask, int64_t n, uint32_t k0,
                    uint32_t k1, uint32_t thresh) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t base = t * 4;
  if (base >= n) return;
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(t), static_cast<uint32_t>(t >> 32), 0u,
                 0u),
      make_uint2(k0, k1));
  const uint8_t b[4] = {static_cast<uint8_t>(r.x >= thresh),
                        static_cast<uint8_t>(r.y >= thresh),
                        static_cast<uint8_t>(r.z >= thresh),
                        static_cast<uint8_t>(r.w >= thresh)};
  if (base + 4 <= n) {
    *reinterpret_cast<uchar4*>(mask + base) =
        make_uchar4(b[0], b[1], b[2], b[3]);
  } else {
    for (int i = 0; base + i < n; ++i) mask[base + i] = b[i];
  }
}

}  // namespace

// mask: uint8 (n,), 4-byte aligned.  seed: the 64-bit Philox key (low word
// first).  thresh: keep iff word >= thresh.  Returns cudaGetLastError()
// after the launch.
extern "C" int mx_dropout_mask(void* mask, long long n, unsigned long long seed,
                               unsigned int thresh, void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(mask) % 4 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long words = (n + 3) / 4;
  const long long blocks = (words + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dropout_mask_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(mask), n, static_cast<uint32_t>(seed),
      static_cast<uint32_t>(seed >> 32), thresh);
  return static_cast<int>(cudaGetLastError());
}
