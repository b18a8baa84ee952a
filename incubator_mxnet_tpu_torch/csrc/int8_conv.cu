// int8 post-training-quantized convolution for sm_90a: an implicit GEMM
// with the activation's quantization fused into its loads and the
// per-channel rescale and bias in its epilogue.
//
// Replaces no Pallas kernel: the JAX package's `int8_conv`
// (incubator_mxnet_tpu/contrib/quantization.py:113-136) asks XLA for an
// s8 x s8 -> s32 `conv_general_dilated`, and torch has no int8
// convolution on CUDA (cuDNN and `F.conv*` take no int8 operands there),
// so the port writes it.  Its GEMM case (a 1x1 convolution over
// (M, K, 1, 1)) is `int8_dense` (`:96-110`).  It computes, for x of type
// T (float or bf16), NC[D]HW with 1-3 spatial dims:
//
//   xq  = clip(round_half_even(x / act_scale), -127, 127)      as s8
//   acc = sum over (c, kd, kh, kw) of xq * w_q                  in s32
//   out = T(f32(acc) * scale[o] + bias[o])
//
// with groups, stride, symmetric padding (zeros, so quantized 0) and
// dilation; scale[o] = act_scale * w_scale[o] is staged by the caller in
// f32.  Exactness against the plain version (`int8_conv_reference`, an
// f64 convolution of the same integer values): the division is IEEE
// (`__fdiv_rn`, not a multiply by a reciprocal; no --use_fast_math) and
// rounds with `__float2int_rn` (half to even, as torch.round and
// jnp.round); the sum is exact in s32 (|acc| <= K * 127^2); the epilogue
// is `__fmul_rn` then `__fadd_rn`, which nvcc does not contract into an
// FMA, as the plain version's two torch ops round twice.
//
// Design (the first, simple one).  The GEMM of each group: M = N*OD*OH*OW
// output pixels, Ng = O/G output channels, K = (C/G)*KD*KH*KW.  A block of
// 256 threads computes a 128 x 64 tile of (pixel, channel), walking K in
// steps of 32: each thread gathers 16 activations of one pixel row
// (consecutive threads take consecutive pixels, so a stride-1 row reads
// adjacent addresses), quantizes them and stores them as four words of
// the shared A tile; 8 weights of one channel row go to the B tile; K
// past its end and taps in the padding are 0.  Each thread then
// accumulates an 8 x 4 micro-tile (pixels tx + 16 i, channels ty + 16 j)
// with `dp4a`, four int8 products a word, from conflict-free shared-memory
// rows (a row of 36 bytes).  The epilogue writes NC[D]HW in x's type; for
// a fixed channel, consecutive pixels are adjacent.  Bounds on the H100:
// per shape the larger of the bytes (x read once, the int8 weights, the
// output written once) over 3.35 TB/s and the multiply-adds over the
// int8 tensor-core peak of 1,979 TOPS; most of ResNet-50's shapes are
// byte-bound.  This kernel uses no tensor cores (`dp4a` runs on the
// integer pipes, 64 lanes a clock an SM), re-gathers and re-quantizes the
// activation for every 64-channel column of the output, and loads the
// weights a byte at a time: `mma`/`wgmma` with s8 operands, TMA and an
// NHWC layout are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;           // output pixels a block
constexpr int kBN = 64;            // output channels a block
constexpr int kBK = 32;            // reduction depth a step (bytes)
constexpr int kRow = kBK + 4;      // a shared-memory row, bytes
constexpr int kTM = kBM / 16;      // pixels a thread
constexpr int kTN = kBN / 16;      // channels a thread
constexpr int kAPer = kBM * kBK / kThreads;  // activations a thread loads
constexpr int kBPer = kBN * kBK / kThreads;  // weights a thread loads

struct ConvShape {
  long long n;                 // batch
  int c, o, groups;            // channels in, out, groups
  int id, ih, iw;              // input spatial extents (1 where absent)
  int od, oh, ow;              // output spatial extents
  int kd, kh, kw;              // taps
  int sd, sh, sw;              // strides
  int pd, ph, pw;              // padding (both sides)
  int dd, dh, dw;              // dilations
};

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

// clip(round_half_even(v / s), -127, 127) as an int8 bit pattern.
__device__ __forceinline__ uint32_t quantize(float v, float s) {
  int q = __float2int_rn(__fdiv_rn(v, s));
  q = q < -127 ? -127 : (q > 127 ? 127 : q);
  return static_cast<uint32_t>(q) & 0xffu;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ out,
                 ConvShape sh, float act_scale) {
  __shared__ __align__(16) uint8_t As[kBM * kRow];
  __shared__ __align__(16) uint8_t Bs[kBN * kRow];
  __shared__ long long row_in[kBM];   // offset of (n, group's channel 0)
  __shared__ long long row_out[kBM];  // offset of (n, channel 0, pixel)
  __shared__ int row_z[kBM], row_y[kBM], row_x[kBM];  // first tap's coords

  const int g = blockIdx.z;
  const int cg = sh.c / sh.groups;
  const int ng = sh.o / sh.groups;
  const int taps = sh.kd * sh.kh * sh.kw;
  const int K = cg * taps;
  const long long osp = static_cast<long long>(sh.od) * sh.oh * sh.ow;
  const long long isp = static_cast<long long>(sh.id) * sh.ih * sh.iw;
  const long long M = sh.n * osp;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int o0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;

  for (int r = tid; r < kBM; r += kThreads) {
    const long long m = m0 + r;
    if (m < M) {
      const long long nb = m / osp;
      long long sp = m - nb * osp;
      const int ox = static_cast<int>(sp % sh.ow);
      sp /= sh.ow;
      const int oy = static_cast<int>(sp % sh.oh);
      const int oz = static_cast<int>(sp / sh.oh);
      row_in[r] = (nb * sh.c + static_cast<long long>(g) * cg) * isp;
      row_out[r] = nb * sh.o * osp + (m - nb * osp);
      row_z[r] = oz * sh.sd - sh.pd;
      row_y[r] = oy * sh.sh - sh.ph;
      row_x[r] = ox * sh.sw - sh.pw;
    } else {
      row_in[r] = -1;
    }
  }
  __syncthreads();

  const int tx = tid & 15, ty = tid >> 4;
  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  const int a_row = tid % kBM;                 // the pixel this thread loads
  const int a_k = (tid / kBM) * kAPer;         // and its first depth
  const int b_row = tid % kBN;
  const int b_k = (tid / kBN) * kBPer;
  const long long in_base = row_in[a_row];
  const int z0 = row_z[a_row], y0 = row_y[a_row], x0 = row_x[a_row];
  const int b_o = o0 + b_row;
  const int8_t* wrow = w + (static_cast<long long>(g) * ng + b_o) * K;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A: 16 quantized activations of pixel a_row at depths k0 + a_k + e
    {
      int k = k0 + a_k;
      int c = k / taps;
      int t = k - c * taps;
      int kz = t / (sh.kh * sh.kw);
      t -= kz * sh.kh * sh.kw;
      int ky = t / sh.kw;
      int kx = t - ky * sh.kw;
      uint32_t words[kAPer / 4];
#pragma unroll
      for (int e = 0; e < kAPer; ++e) {
        uint32_t q = 0;
        if (in_base >= 0 && k < K) {
          const int z = z0 + kz * sh.dd, y = y0 + ky * sh.dh,
                    xx = x0 + kx * sh.dw;
          if (z >= 0 && z < sh.id && y >= 0 && y < sh.ih && xx >= 0 &&
              xx < sh.iw) {
            const long long off =
                in_base + static_cast<long long>(c) * isp +
                (static_cast<long long>(z) * sh.ih + y) * sh.iw + xx;
            q = quantize(to_f32(x[off]), act_scale);
          }
        }
        if ((e & 3) == 0) words[e >> 2] = 0;
        words[e >> 2] |= q << (8 * (e & 3));
        // the next depth: kw fastest, then kh, kd, channel
        ++k;
        if (++kx == sh.kw) {
          kx = 0;
          if (++ky == sh.kh) {
            ky = 0;
            if (++kz == sh.kd) {
              kz = 0;
              ++c;
            }
          }
        }
      }
      uint32_t* dst = reinterpret_cast<uint32_t*>(As + a_row * kRow + a_k);
#pragma unroll
      for (int v = 0; v < kAPer / 4; ++v) dst[v] = words[v];
    }
    // B: 8 weights of channel b_o at depths k0 + b_k + e
    {
      uint32_t words[kBPer / 4];
#pragma unroll
      for (int e = 0; e < kBPer; ++e) {
        const int k = k0 + b_k + e;
        const uint32_t q =
            (b_o < ng && k < K) ? static_cast<uint8_t>(wrow[k]) : 0u;
        if ((e & 3) == 0) words[e >> 2] = 0;
        words[e >> 2] |= q << (8 * (e & 3));
      }
      uint32_t* dst = reinterpret_cast<uint32_t*>(Bs + b_row * kRow + b_k);
#pragma unroll
      for (int v = 0; v < kBPer / 4; ++v) dst[v] = words[v];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      int a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        a[i] = *reinterpret_cast<const int*>(As + (tx + 16 * i) * kRow + kk);
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        b[j] = *reinterpret_cast<const int*>(Bs + (ty + 16 * j) * kRow + kk);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = tx + 16 * i;
    if (m0 + r >= M) continue;
    const long long ob = row_out[r];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int o = o0 + ty + 16 * j;
      if (o >= ng) continue;
      const int go = g * ng + o;
      float v = __fmul_rn(__int2float_rn(acc[i][j]), scale[go]);
      if (bias != nullptr) v = __fadd_rn(v, bias[go]);
      out[ob + static_cast<long long>(go) * osp] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, const ConvShape& sh, float act_scale, void* stream) {
  const long long M = sh.n * sh.od * sh.oh * sh.ow;
  const int ng = sh.o / sh.groups;
  if (M <= 0 || ng <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((ng + kBN - 1) / kBN),
                  static_cast<unsigned>(sh.groups));
  int8_conv_kernel<T><<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), sh, act_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, c, id, ih, iw) of dtype (0 float32, 1 bfloat16), contiguous;
// w: (o, c / groups, kd, kh, kw) int8, contiguous; scale: (o,) float32,
// act_scale * w_scale; bias: (o,) float32 or null; out: (n, o, od, oh, ow)
// of x's dtype.  dims: the 22 ints n, c, o, groups, id, ih, iw, od, oh,
// ow, kd, kh, kw, sd, sh, sw, pd, ph, pw, dd, dh, dw.  Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int mx_int8_conv(const void* x, const void* w, const void* scale,
                            const void* bias, void* out, const long long* dims,
                            float act_scale, int dtype, void* stream) {
  int d[22];
  for (int i = 1; i < 22; ++i) d[i] = static_cast<int>(dims[i]);
  const ConvShape sh{dims[0], d[1],  d[2],  d[3],  d[4],  d[5],  d[6],  d[7],
                     d[8],    d[9],  d[10], d[11], d[12], d[13], d[14], d[15],
                     d[16],   d[17], d[18], d[19], d[20], d[21]};
  if (sh.groups <= 0 || sh.c % sh.groups || sh.o % sh.groups)
    return static_cast<int>(cudaErrorInvalidValue);
  if (sh.groups > 65535 || (sh.o / sh.groups + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch<float>(x, w, scale, bias, out, sh, act_scale, stream);
    case 1:
      return launch<__nv_bfloat16>(x, w, scale, bias, out, sh, act_scale,
                                   stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
