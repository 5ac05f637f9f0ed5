// int8 x int8 -> int32 convolution for Hopper (sm_90a), with the dynamic-range
// rescale y = float(sum) * (sx[b] * sw[n]) + bias[n] fused into its epilogue.
//
// Replaces no TPU kernel: the JAX package computes this convolution with
// lax.conv_general_dilated(..., preferred_element_type=int32) in
// sar_yolo_tpu/nn/modules/conv.py::Int8Conv2D (line 87), which XLA lowers for
// the TPU's int8 matrix unit. The port has no XLA, and a cuDNN or
// torch._int_mm call would be a library's kernel, so the int8 path of `int8`
// serving runs here.
//
// Function. An implicit GEMM: M = B * Ho * Wo output pixels, N = C_out
// filters, K = kh * kw * C_in. x is int8 NHWC (B, H, W, Cp) and w int8
// (C_out, kh, kw, Cp), Cp = C_in padded with zeros to a multiple of 4 by the
// wrapper, so K runs contiguously along the channels in 4-byte words. The sums
// are exact in int32 (|sum| <= 127^2 K < 2^31 for K < 133,000). The output is
// NCHW, float32 or bf16 (or the raw int32 sums, for checking).
//
// Bound. bytes = B*H*W*C_in + C_out*K (int8 in) + B*C_out*Ho*Wo*itemsize
// (out); operations = 2*M*N*K at 1979 TOPS dense int8. The served yolov13-JDE
// convolutions at 640 are bound by bytes at scale n and by operations at l.
//
// Design (simple first): a 256-thread block computes a 64 x 64 tile of
// (pixels, filters); each thread holds a 4 x 4 int32 accumulator, rows
// tx + 16 i and columns ty + 16 j, so a warp's stores run along 16
// neighbouring pixels of one NCHW plane. K advances 8 words (32 int8) at a
// time: each thread stages one word of A (gathered from x with the padding
// and dilation of its two rows, zero outside the image) and one of B into
// shared memory (pitch 68 words: the stores of a warp's 8 k-words x 4 rows hit
// 32 banks), then 8 x 16 __dp4a. No tensor cores yet: mma.sync
// m16n8k32.s8 or wgmma is the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBKW = 8, kThreads = 256, kPitch = kBM + 4;

struct Geometry {
  int batch, h, w, cw, n, kh, kw, ho, wo, stride, pad, dil;  // cw: Cp / 4
};

__device__ __forceinline__ void store(float* y, long long i, float v) { y[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* y, long long i, float v) {
  y[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(int* y, long long i, int v) { y[i] = v; }

// kSums: write the int32 sums (OutT = int) instead of the rescaled values.
template <typename OutT, bool kSums>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int* __restrict__ x, const int* __restrict__ w,
                     const float* __restrict__ sx, const float* __restrict__ sw,
                     const float* __restrict__ bias, OutT* __restrict__ y, Geometry g) {
  __shared__ int as[kBKW][kPitch];
  __shared__ int bs[kBKW][kPitch];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int hw = g.ho * g.wo, m_total = g.batch * hw;
  const int k_total = g.kh * g.kw * g.cw;  // 32-bit words
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  // the staged word of this thread: k-word kk of rows r and r + 32
  const int kk = tid % kBKW, r0 = tid / kBKW;
  long long a_base[2];
  int a_ih[2], a_iw[2];
  bool a_ok[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int m = m0 + r0 + 32 * s;
    a_ok[s] = m < m_total;
    const int b = a_ok[s] ? m / hw : 0, p = a_ok[s] ? m - (m / hw) * hw : 0;
    const int oh = p / g.wo, ow = p - oh * g.wo;
    a_base[s] = (long long)b * g.h * g.w * g.cw;
    a_ih[s] = oh * g.stride - g.pad;
    a_iw[s] = ow * g.stride - g.pad;
  }

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k_total; k0 += kBKW) {
    const int k = k0 + kk;
    const bool k_ok = k < k_total;
    const int tap = k_ok ? k / g.cw : 0, c = k - tap * g.cw;
    const int ky = tap / g.kw, kx = tap - ky * g.kw;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int ih = a_ih[s] + ky * g.dil, iw = a_iw[s] + kx * g.dil;
      const bool in = k_ok && a_ok[s] && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w;
      as[kk][r0 + 32 * s] = in ? x[a_base[s] + ((long long)ih * g.w + iw) * g.cw + c] : 0;
      const int n = n0 + r0 + 32 * s;
      bs[kk][r0 + 32 * s] = (k_ok && n < g.n) ? w[(long long)n * k_total + k] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kBKW; ++q) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[q][tx + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[q][ty + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tx + 16 * i;
    if (m >= m_total) continue;
    const int b = m / hw, p = m - b * hw;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + ty + 16 * j;
      if (n >= g.n) continue;
      const long long o = ((long long)b * g.n + n) * hw + p;
      if constexpr (kSums) {
        store(y, o, acc[i][j]);
      } else {
        // the JAX package's order: float(sum) * (sx * sw) + bias, no FMA contraction
        const float s = __fmul_rn(sx[b], sw[n]);
        store(y, o, __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), s), bias[n]));
      }
    }
  }
}

template <typename OutT, bool kSums>
int launch(const void* x, const void* w, const void* sx, const void* sw, const void* bias,
           void* y, const int* geo, void* stream) {
  const Geometry g{geo[0], geo[1], geo[2], geo[3], geo[4],  geo[5],
                   geo[6], geo[7], geo[8], geo[9], geo[10], geo[11]};
  const long long m_total = (long long)g.batch * g.ho * g.wo;
  const dim3 grid((unsigned)((m_total + kBM - 1) / kBM), (unsigned)((g.n + kBN - 1) / kBN));
  int8_conv_kernel<OutT, kSums><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)x, (const int*)w, (const float*)sx, (const float*)sw, (const float*)bias,
      (OutT*)y, g);
  return (int)cudaGetLastError();
}

}  // namespace

// geo: batch, H, W, Cp / 4, C_out, kh, kw, Ho, Wo, stride, padding, dilation.
extern "C" int int8_conv_f32(const void* x, const void* w, const void* sx, const void* sw,
                             const void* bias, void* y, const int* geo, void* stream) {
  return launch<float, false>(x, w, sx, sw, bias, y, geo, stream);
}

extern "C" int int8_conv_bf16(const void* x, const void* w, const void* sx, const void* sw,
                              const void* bias, void* y, const int* geo, void* stream) {
  return launch<__nv_bfloat16, false>(x, w, sx, sw, bias, y, geo, stream);
}

extern "C" int int8_conv_sums(const void* x, const void* w, void* y, const int* geo,
                              void* stream) {
  return launch<int, true>(x, w, nullptr, nullptr, nullptr, y, geo, stream);
}
