// The activation quantize of the int8 convolution, for sm_90a: x (float or
// bf16, NC[D]HW) read once and written as an int8 channels-last buffer, the
// A operand of the implicit GEMM in int8_conv.cu.
//
// Replaces no Pallas kernel: it is the first line of the JAX package's
// `int8_conv` and `int8_dense` (incubator_mxnet_tpu/contrib/quantization.py
// :98 and :119), which XLA fuses into its s8 convolution:
//
//   xq = clip(round_half_even(x / act_scale), -127, 127)      as s8
//
// written as (N, QD, QH, QW, G, Cp): a pixel's channels of group g are Cp
// contiguous bytes, C/G rounded up to 16 with zeros in the padding lanes,
// so the convolution reads a tap's channels as 16-byte copies.  With
// subsample strides (sd, sh, sw) -- a 1x1 convolution without padding --
// the buffer holds only the pixels the convolution reads, x[..., ::sd,
// ::sh, ::sw], and the convolution is a dense GEMM over them.  With a
// fold (kw, pw, dw) -- a kernel whose width taps fit the 16-byte padding
// of few channels, such as the stem's 3 -- buffer column qx holds, in
// (kx, c) order, the channels of input columns qx * sw - pw + kx * dw for
// kx < kw (zeros outside the input), Cp = kw * C/G rounded up, and the
// convolution's kernel is kd x kh x 1.  Otherwise the strides are 1 and
// Q = the input's extents.  The division is IEEE
// (`__fdiv_rn`, not a multiply by a reciprocal; no --use_fast_math) and
// rounds half to even with `__float2int_rn`, as `quantize_activation`'s
// torch ops do, so the bytes are those of the plain version
// (`quantize_channels_last_reference` in ops/int8_conv.py).
//
// Bound on the H100: bytes, x read once (2 or 4 bytes an element) and the
// buffer written once (1 byte a padded element), over 3.35 TB/s.  Design: a
// block of 256 threads owns 4,096 bytes of the buffer, px pixels x cw bytes
// of a pixel's (G, Cp) row (cw the narrowest of 16, 32, 64 that holds the
// row, so the stem's 3 channels do not idle three quarters of a block).
// Each thread issues its 16 loads together, consecutive threads on
// consecutive pixels of one channel (adjacent addresses when the strides
// are 1), then quantizes them into a shared-memory tile (a pixel's bytes
// in a row), and writes one 16-byte vector of a pixel's row.  No inline
// PTX: the tests run this source on the host under a stand-in runtime.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                      // elements a thread
constexpr int kTile = kThreads * kPer;        // bytes of out a block
constexpr int kMaxCols = 64;                  // bytes of a pixel's row

struct QuantShape {
  long long n;                 // batch
  int c, groups, cp;           // channels, groups, bytes a group a pixel
  int id, ih, iw;              // x's spatial extents (1 where absent)
  int qd, qh, qw;              // the buffer's spatial extents
  int sd, sh, sw;              // subsample strides
  int kw, pw, dw;              // the fold's width taps, padding, dilation
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// clip(round_half_even(v / s), -127, 127) as an int8 bit pattern: the IEEE
// quotient, clamped to [-128, 128] in f32 (where every value rounds
// exactly), rounded half to even by adding 1.5 * 2^23 (the integer lands
// in the low bits of the sum; no quarter-rate float-to-int conversion),
// then clipped to +-127; NaN gives 0, as `__float2int_rn` does.
__device__ __forceinline__ uint8_t quantize(float v, float s) {
  const float q = __fdiv_rn(v, s);
  const float c = fminf(fmaxf(q, -128.f), 128.f);
  int i = __float_as_int(__fadd_rn(c, 12582912.f)) - 0x4B400000;
  i = i < -127 ? -127 : (i > 127 ? 127 : i);
  return q != q ? 0 : static_cast<uint8_t>(i & 0xff);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// Block (pt, ct) owns pixels [px pt, + px) and bytes [cw ct, + cw) of a
// pixel's (G, Cp) row, cw = 2^cw_shift (16, 32 or 64), px = 4096 / cw;
// with kFold a byte's input column is the pixel's first one plus its
// tap's shift, and is tested against the input's width.  With VP > 1
// (the buffer's pixels are x's, and VP divides an image's pixels) a
// thread reads VP adjacent pixels of one channel as one vector.
template <typename T, bool kFold, int VP>
__global__ void __launch_bounds__(kThreads)
quantize_cl_kernel(const void* __restrict__ xv, uint8_t* __restrict__ out,
                   QuantShape sh, int cw_shift, float act_scale) {
  const T* __restrict__ x = static_cast<const T*>(xv);
  __shared__ __align__(16) uint8_t tile[kTile + 16 * (kTile / 16)];
  __shared__ long long src[kTile / 16];  // x's offset of (n, 0, z, y, 0)
  __shared__ int col[kTile / 16];        // and the pixel's first column
  __shared__ long long chan[kMaxCols];   // a byte's channel offset in x
  __shared__ int shift[kMaxCols];        // and its column offset (kx dw)

  const int cw = 1 << cw_shift;
  const int px_shift = 12 - cw_shift;    // kTile = 2^12
  const int px = 1 << px_shift;
  const int row = cw + 16;               // a pixel's bytes in the tile
  const int cg = sh.c / sh.groups;
  const int fw = sh.kw * cg;             // the folded bytes of a group
  const long long row_bytes = static_cast<long long>(sh.groups) * sh.cp;
  const long long qsp = static_cast<long long>(sh.qd) * sh.qh * sh.qw;
  const long long isp = static_cast<long long>(sh.id) * sh.ih * sh.iw;
  const long long P = sh.n * qsp;
  const long long p0 = static_cast<long long>(blockIdx.x) * px;
  const int j0 = blockIdx.y * cw;
  const int tid = threadIdx.x;

  if (tid < px) {
    const long long p = p0 + tid;
    if (p < P) {
      const long long nb = p / qsp;
      long long sp = p - nb * qsp;
      const int qx = static_cast<int>(sp % sh.qw);
      sp /= sh.qw;
      const int qy = static_cast<int>(sp % sh.qh);
      const int qz = static_cast<int>(sp / sh.qh);
      src[tid] = nb * sh.c * isp +
                 (static_cast<long long>(qz) * sh.sd * sh.ih +
                  static_cast<long long>(qy) * sh.sh) * sh.iw +
                 (kFold ? 0 : qx * sh.sw);
      col[tid] = qx * sh.sw - sh.pw;
    } else {
      src[tid] = -1;
    }
  }
  if (tid < cw) {
    // byte r of group g's row: width tap r / cg, channel r % cg
    const int j = j0 + tid;
    const int g = j / sh.cp;
    const int r = j - g * sh.cp;
    const int kx = r / cg;
    chan[tid] = g < sh.groups && r < fw
                    ? static_cast<long long>(g * cg + r - kx * cg) * isp
                    : -1;
    shift[tid] = kx * sh.dw;
  }
  __syncthreads();

  if (VP > 1) {
    // read: vector u = tid + 256 i is pixels VP (u % (px / VP)) on of
    // byte u / (px / VP); the loads go out together
    constexpr int kVecs = kPer / VP;
    const int groups = px / VP;
    Vec<T, VP> v[kVecs];
    unsigned live = 0;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int u = tid + kThreads * i;
      const long long base = src[(u % groups) * VP];
      const long long off = chan[u / groups];
      live |= static_cast<unsigned>(base >= 0 && off >= 0) << i;
      if ((live >> i) & 1u)
        v[i] = *reinterpret_cast<const Vec<T, VP>*>(x + base + off);
    }
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int u = tid + kThreads * i;
      const int p = (u % groups) * VP, jj = u / groups;
#pragma unroll
      for (int e = 0; e < VP; ++e)
        tile[(p + e) * row + jj] =
            (live >> i) & 1u ? quantize(to_f32(v[i].v[e]), act_scale) : 0;
    }
  } else {
    // read: pixel tid % px, bytes tid / px + (cw / 16) i; every load issued
    // before the first division, so they are in flight together
    const int p = tid & (px - 1);
    const int c0 = tid >> px_shift;
    const int step = kThreads >> px_shift;
    const long long base = src[p];
    const int x0 = col[p];
    float v[kPer];
    unsigned live = 0;                   // bytes of a channel, not padding
  #pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const long long off = chan[c0 + step * i];
      live |= static_cast<unsigned>(off >= 0) << i;
      if (kFold) {
        const int xi = x0 + shift[c0 + step * i];
        v[i] = base >= 0 && off >= 0 && xi >= 0 && xi < sh.iw
                   ? to_f32(x[base + off + xi]) : 0.f;
      } else {
        v[i] = base >= 0 && off >= 0 ? to_f32(x[base + off]) : 0.f;
      }
    }
    // a warp's threads share c0 (px >= 64), so the test of a padding
    // lane (no division) is uniform across the warp; a pixel's tap
    // outside the input quantizes 0 to 0
  #pragma unroll
    for (int i = 0; i < kPer; ++i)
      tile[p * row + c0 + step * i] =
          (live >> i) & 1u ? quantize(v[i], act_scale) : 0;
  }
  __syncthreads();

  // write: one 16-byte vector a thread, a pixel's side by side
  {
    const int p = tid >> (cw_shift - 4);
    const int j = j0 + 16 * (tid & (cw / 16 - 1));
    if (p0 + p < P && j < row_bytes)
      *reinterpret_cast<uint4*>(out + (p0 + p) * row_bytes + j) =
          *reinterpret_cast<const uint4*>(tile + p * row + (j - j0));
  }
}

using Kernel = void (*)(const void*, uint8_t*, QuantShape, int, float);

template <typename T, bool kFold, int VP>
Kernel kernel_of() {
  return quantize_cl_kernel<T, kFold, VP>;
}

template <typename T>
int launch(const void* x, void* out, const QuantShape& sh, float act_scale,
           void* stream) {
  const long long P = sh.n * sh.qd * sh.qh * sh.qw;
  const long long row_bytes = static_cast<long long>(sh.groups) * sh.cp;
  if (P <= 0) return 0;
  // the narrowest of 16, 32, 64 bytes that holds the row (64 above)
  const int cw_shift = row_bytes <= 16 ? 4 : row_bytes <= 32 ? 5 : 6;
  const long long px = kTile >> cw_shift;
  const long long blocks = (P + px - 1) / px;
  const long long cols = (row_bytes + (1 << cw_shift) - 1) >> cw_shift;
  if (blocks > 0x7fffffffLL || cols > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(cols));
  // VP pixels a vector load where the buffer's pixels are x's: a power of
  // two up to 16 bytes that divides an image's pixels and x's alignment
  const long long isp = static_cast<long long>(sh.id) * sh.ih * sh.iw;
  const bool plain = sh.kw == 1 && sh.sd == 1 && sh.sh == 1 && sh.sw == 1 &&
                     sh.qd == sh.id && sh.qh == sh.ih && sh.qw == sh.iw;
  int vp = 1;
  for (int v = 16 / static_cast<int>(sizeof(T)); v > 1 && vp == 1; v /= 2)
    if (plain && isp % v == 0 &&
        reinterpret_cast<uintptr_t>(x) % (v * sizeof(T)) == 0)
      vp = v;
  const Kernel kernel = sh.kw > 1 ? kernel_of<T, true, 1>()
                        : vp == 8  ? kernel_of<T, false, 8>()
                        : vp == 4  ? kernel_of<T, false, 4>()
                        : vp == 2  ? kernel_of<T, false, 2>()
                                   : kernel_of<T, false, 1>();
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<uint8_t*>(out), sh, cw_shift, act_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, c, id, ih, iw) of dtype (0 float32, 1 bfloat16), contiguous; out:
// (n, qd, qh, qw, groups, cp) int8, contiguous, 16-byte aligned.  dims: the
// 16 ints n, c, groups, cp, id, ih, iw, qd, qh, qw, sd, sh, sw, kw, pw, dw
// (kw = 1, pw = 0 without a fold); cp a multiple of 16 and >= kw * c /
// groups.  Launches on `stream` and returns cudaGetLastError() after the
// launch.
extern "C" int mx_int8_quantize_cl(const void* x, void* out,
                                   const long long* dims, float act_scale,
                                   int dtype, void* stream) {
  int d[16];
  for (int i = 1; i < 16; ++i) d[i] = static_cast<int>(dims[i]);
  const QuantShape sh{dims[0], d[1],  d[2],  d[3],  d[4],  d[5],
                      d[6],    d[7],  d[8],  d[9],  d[10], d[11],
                      d[12],   d[13], d[14], d[15]};
  if (sh.groups <= 0 || sh.c % sh.groups || sh.cp % 16 || sh.kw < 1 ||
      sh.cp < sh.kw * (sh.c / sh.groups))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch<float>(x, out, sh, act_scale, stream);
    case 1:
      return launch<__nv_bfloat16>(x, out, sh, act_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
