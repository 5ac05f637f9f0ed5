// int8 x int8 -> int32 convolution for Hopper (sm_90a) on the int8 tensor cores, with the
// dynamic-range rescale y = float(sum) * (sx[b] * sw[n]) + bias[n] fused into its epilogue.
//
// Replaces no TPU kernel: the JAX package computes this convolution with
// lax.conv_general_dilated(..., preferred_element_type=int32) in
// sar_yolo_tpu/nn/modules/conv.py::Int8Conv2D (the conv at line 122), which XLA lowers for
// the TPU's int8 matrix unit. The port has no XLA, and a cuDNN or torch._int_mm call would
// be a library's kernel, so the int8 path of `int8` serving runs here. Its quantization is
// the other kernel of the path, int8_quant.cu.
//
// Function. An implicit GEMM: N = C_out filters (the MMA rows), M = B * Ho * Wo output
// pixels (the MMA columns), K = kh * kw * Cp. x is int8 NHWC (B, H, W, Cp) and w int8
// (C_out, kh, kw, Cp), Cp = C_in zero-padded by the wrapper to a multiple of 16 (of 4 where
// C_in <= 4, the stem), so K runs contiguously along the channels and a 16-byte (4-byte)
// copy never straddles two taps. The sums are exact in int32 (|sum| <= 127^2 K < 2^31 for
// K < 133,000). The output is NCHW, float32 or bf16 (or the raw int32 sums, for checking).
//
// Bound. bytes = B*H*W*C_in + C_out*K (int8 in) + B*C_out*Ho*Wo*itemsize (out); operations
// = 2*M*N*K at 1979 TOP/s dense int8. The served yolov13-JDE convolutions at 640 are bound
// by bytes at scale n (narrow filters, wide maps: the float32 output dominates) and by
// operations at l's wide 3x3 layers.
//
// Design.
// * Tensor cores: mma.sync m16n8k32 s8 x s8 -> s32, both operands fed by ldmatrix.x4 from
//   K-contiguous rows in shared memory (filters as A, row-major; pixels as B, "col").
// * A 4-stage ring of 64-byte K slices in dynamic shared memory, filled by cp.async (16-byte
//   .cg copies, 4-byte .ca at the stem). The im2col gather is the copy's source address;
//   padding, out-of-image taps and rows past N or M use the zero-fill form (src-size 0). Past
//   K only the filter rows are zero-filled and the pixel rows are not copied at all (the
//   zeros cancel whatever they hold): the stem's K of 36 bytes fills 9 of a stage's 16
//   4-byte columns. The 16-byte chunks of a 64-byte row are XOR-swizzled by (row >> 1) & 3,
//   so the eight rows of an ldmatrix phase hit eight distinct bank groups. 128-byte stages
//   (3 or 4) and 6 stages of 64 bytes measured slower on an H100 (PERF.md, section 6).
// * Tiles (filters x pixels): 128x64, 64x128, 64x64, 32x128 and 16x128 (4 warps, 8 for
//   64x128), each warp kMF x kNP m16n8 accumulators. The wrapper picks one from (M, N, K):
//   no wider in filters than C_out needs (the stem's 16 filters waste nothing), the largest
//   that still gives ~3 blocks an SM, else the one with the most blocks; where K >= 1024 at
//   least 64 filters wide, since a narrow tile reloads the wide pixel operand once per 16 or
//   32 filters. A sweep of every tile at every shape of yolov13n/l-JDE @640 b8 set the rule.
// * Epilogue: the int32 tile goes through shared memory (pitch + 8 words: conflict-free
//   8-byte stores of the fragments), then each thread rescales four neighbouring pixels of
//   one filter and stores them as one 16-byte (float32, int32) or 8-byte (bf16) run of an
//   NCHW plane (streaming stores: the output is not read again here), in the JAX package's
//   order (__fmul_rn, __fadd_rn, no FMA contraction).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;  // K bytes of one stage: 2 m16n8k32 steps
constexpr int kStages = 4;
constexpr int kFar = -(1 << 28);  // the input row of a pixel past M: every tap falls outside

struct Geometry {
  int batch, h, w, cp, n, kh, kw, ho, wo, stride, pad, dil;
};

enum Mode { kF32 = 0, kBF16 = 1, kSums = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of (row, k byte) in a region of 64-byte rows, 16-byte chunks swizzled so that
// the eight rows an ldmatrix phase reads hit eight distinct 16-byte bank groups
__device__ __forceinline__ int swz(int row, int k) {
  return row * kBK + ((((k >> 4) ^ (row >> 1)) & 3) << 4) + (k & 15);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(kBytes), "r"(n));
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float rescale(int sum, float s, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(sum), s), bias);
}

template <int kWF, int kWP, int kMF, int kNP>
struct Tile {
  static constexpr int kThreads = kWF * kWP * 32;
  static constexpr int kBF = kWF * kMF * 16;  // filters
  static constexpr int kBP = kWP * kNP * 8;   // pixels
  static constexpr int kStageBytes = (kBF + kBP) * kBK;
  static constexpr int kPitch = kBP + 8;      // int32 words of an epilogue row
  static constexpr int kSmem = kStages * kStageBytes > kBF * kPitch * 4
                                   ? kStages * kStageBytes : kBF * kPitch * 4;
};

// kCB: bytes of one cp.async (16, or 4 where Cp % 16 != 0)
template <int kWF, int kWP, int kMF, int kNP, int kCB>
__global__ void __launch_bounds__(kWF * kWP * 32, kWF * kWP == 8 ? 2 : 4)
    int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ sx, const float* __restrict__ sw,
                     const float* __restrict__ bias, void* __restrict__ y, int mode, Geometry g) {
  using T = Tile<kWF, kWP, kMF, kNP>;
  constexpr int kThreads = T::kThreads, kBF = T::kBF, kBP = T::kBP;
  constexpr int kCPR = kBK / kCB;          // copies of one row of a stage
  constexpr int kRows = kThreads / kCPR;   // rows one pass of copies covers
  constexpr int kPassP = kBP / kRows;
  constexpr int kPassF = (kBF + kRows - 1) / kRows;
  static_assert(kThreads % kCPR == 0 && kBP % kRows == 0 && kNP % 2 == 0, "tile");
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wf = warp / kWP, wp = warp - wf * kWP;
  const int hw = g.ho * g.wo, m_total = g.batch * hw;
  const int K = g.kh * g.kw * g.cp;
  const int m0 = blockIdx.x * kBP, n0 = blockIdx.y * kBF;

  // this thread's copies: chunk cc of rows r0 + kRows * i. A pixel row's input origin (ih,
  // iw, offset) stays in registers for 16-byte copies; 4-byte copies give a thread 8-16 rows,
  // whose origins are stepped through again at each stage instead (the stem's K fits one).
  const int cc = tid % kCPR, r0 = tid / kCPR;
  auto origin = [&](int i, int& ih, int& iw, int& off) {
    const int m = m0 + r0 + kRows * i;
    if (m < m_total) {
      const int b = m / hw, p = m - b * hw, oh = p / g.wo, ow = p - oh * g.wo;
      ih = oh * g.stride - g.pad;
      iw = ow * g.stride - g.pad;
      off = ((b * g.h + ih) * g.w + iw) * g.cp;
    } else {
      ih = iw = kFar;
      off = 0;
    }
  };
  constexpr int kKept = kCB == 16 ? kPassP : 1;
  int p_ih[kKept], p_iw[kKept], p_off[kKept];
  if constexpr (kCB == 16) {
#pragma unroll
    for (int i = 0; i < kPassP; ++i) origin(i, p_ih[i], p_iw[i], p_off[i]);
  }
  // the tap (ky, kx) and channel ch of this thread's k byte kb, advanced a stage at a time
  int kb = cc * kCB;
  int tap = kb / g.cp, ch = kb - tap * g.cp;
  int ky = tap / g.kw, kx = tap - ky * g.kw;

  auto load = [&](int stage) {
    unsigned char* sa = smem + stage * T::kStageBytes;
    unsigned char* sb = sa + kBF * kBK;
    const bool k_ok = kb < K;
    const int dy = ky * g.dil, dx = kx * g.dil;
    const int tap_off = (dy * g.w + dx) * g.cp + ch;
    // past K only the filters are zero-filled: their zeros cancel whatever the pixel rows hold
    if (k_ok) {
      int m = m0 + r0, b = 0, oh = 0, ow = 0;  // 4-byte copies: the row, stepped along
      if constexpr (kCB != 16) {
        b = m / hw;
        oh = (m - b * hw) / g.wo;
        ow = m - b * hw - oh * g.wo;
      }
#pragma unroll
      for (int i = 0; i < kPassP; ++i) {
        int ih = kFar, iw = kFar, off = 0;
        if constexpr (kCB == 16) {
          ih = p_ih[i];
          iw = p_iw[i];
          off = p_off[i];
        } else {
          if (m < m_total) {
            ih = oh * g.stride - g.pad;
            iw = ow * g.stride - g.pad;
            off = ((b * g.h + ih) * g.w + iw) * g.cp;
          }
          m += kRows;
          for (ow += kRows; ow >= g.wo; ow -= g.wo) {
            if (++oh == g.ho) {
              oh = 0;
              ++b;
            }
          }
        }
        ih += dy;
        iw += dx;
        const bool ok = (unsigned)ih < (unsigned)g.h && (unsigned)iw < (unsigned)g.w;
        cp_async<kCB>(smem_u32(sb + swz(r0 + kRows * i, cc * kCB)), ok ? x + off + tap_off : x,
                      ok);
      }
    }
#pragma unroll
    for (int i = 0; i < kPassF; ++i) {
      const int row = r0 + kRows * i;
      if (kBF % kRows == 0 || row < kBF) {
        const bool ok = k_ok && n0 + row < g.n;
        cp_async<kCB>(smem_u32(sa + swz(row, cc * kCB)),
                      ok ? w + (long long)(n0 + row) * K + kb : w, ok);
      }
    }
    kb += kBK;
    for (ch += kBK; ch >= g.cp; ch -= g.cp) {
      if (++kx == g.kw) {
        kx = 0;
        ++ky;
      }
    }
  };

  int acc[kMF][kNP][4];
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int j = 0; j < kNP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int kt_total = (K + kBK - 1) / kBK, k32 = (K + 31) / 32;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_total) load(s);
    cp_commit();
  }
  for (int kt = 0; kt < kt_total; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < kt_total) load((kt + kStages - 1) % kStages);
    cp_commit();
    const unsigned char* sa = smem + (kt % kStages) * T::kStageBytes;
    const unsigned char* sb = sa + kBF * kBK;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      if (kBK / 32 * kt + ks >= k32) break;  // K padded to 32 bytes, not to the stage's kBK
      uint32_t bf[kNP][2];
#pragma unroll
      for (int j = 0; j < kNP / 2; ++j) {
        uint32_t r[4];
        const int row = wp * kNP * 8 + j * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(smem_u32(sb + swz(row, ks * 32 + ((lane >> 3) & 1) * 16)), r);
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMF; ++i) {
        uint32_t af[4];
        const int row = wf * kMF * 16 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(smem_u32(sa + swz(row, ks * 32 + (lane >> 4) * 16)), af);
#pragma unroll
        for (int j = 0; j < kNP; ++j) mma_s8(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // the int32 tile through shared memory: rows filters, columns pixels
  int* tile = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int j = 0; j < kNP; ++j) {
      const int f = wf * kMF * 16 + i * 16 + (lane >> 2), c = wp * kNP * 8 + j * 8 + (lane & 3) * 2;
      *reinterpret_cast<int2*>(tile + f * T::kPitch + c) = make_int2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<int2*>(tile + (f + 8) * T::kPitch + c) =
          make_int2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();

  // four neighbouring pixels of one filter a thread: one 16- or 8-byte store of an NCHW run
  constexpr int kGroups = kBP / 4;
  const bool runs = hw % 4 == 0;  // then four pixels from a multiple of 4 share one image
  for (int q = tid; q < kBF * kGroups; q += kThreads) {
    const int f = q / kGroups, c = (q - f * kGroups) * 4;
    const int n = n0 + f, m = m0 + c;
    if (n >= g.n || m >= m_total) continue;
    const int4 v = *reinterpret_cast<const int4*>(tile + f * T::kPitch + c);
    const int sums[4] = {v.x, v.y, v.z, v.w};
    const float swn = mode == kSums ? 0.f : sw[n], bn = mode == kSums ? 0.f : bias[n];
    if (runs && m + 3 < m_total) {
      const int b = m / hw, p = m - b * hw;
      const long long o = ((long long)b * g.n + n) * hw + p;
      if (mode == kSums) {
        __stcs(reinterpret_cast<int4*>(static_cast<int*>(y) + o), v);
      } else {
        const float s = __fmul_rn(sx[b], swn);
        float r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) r[e] = rescale(sums[e], s, bn);
        if (mode == kF32) {
          __stcs(reinterpret_cast<float4*>(static_cast<float*>(y) + o),
                 make_float4(r[0], r[1], r[2], r[3]));
        } else {
          __nv_bfloat162 lo = __floats2bfloat162_rn(r[0], r[1]);
          __nv_bfloat162 hi = __floats2bfloat162_rn(r[2], r[3]);
          uint2 packed;
          packed.x = *reinterpret_cast<uint32_t*>(&lo);
          packed.y = *reinterpret_cast<uint32_t*>(&hi);
          __stcs(reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(y) + o), packed);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int mm = m + e;
        if (mm >= m_total) break;
        const int b = mm / hw, p = mm - b * hw;
        const long long o = ((long long)b * g.n + n) * hw + p;
        if (mode == kSums) {
          static_cast<int*>(y)[o] = sums[e];
        } else {
          const float r = rescale(sums[e], __fmul_rn(sx[b], swn), bn);
          if (mode == kF32) {
            static_cast<float*>(y)[o] = r;
          } else {
            static_cast<__nv_bfloat16*>(y)[o] = __float2bfloat16_rn(r);
          }
        }
      }
    }
  }
}

template <int kWF, int kWP, int kMF, int kNP, int kCB>
int launch_tile(const void* x, const void* w, const void* sx, const void* sw, const void* bias,
                void* y, int mode, const Geometry& g, cudaStream_t stream) {
  using T = Tile<kWF, kWP, kMF, kNP>;
  auto kernel = int8_conv_kernel<kWF, kWP, kMF, kNP, kCB>;
  static unsigned opted_in = 0;  // the devices (a bit each) where kSmem is allowed already
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(opted_in & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) opted_in |= 1u << dev;
  }
  const long long m_total = (long long)g.batch * g.ho * g.wo;
  const dim3 grid((unsigned)((m_total + T::kBP - 1) / T::kBP),
                  (unsigned)((g.n + T::kBF - 1) / T::kBF));
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>((const int8_t*)x, (const int8_t*)w,
                                                  (const float*)sx, (const float*)sw,
                                                  (const float*)bias, y, mode, g);
  return (int)cudaGetLastError();
}

// the tiles, by index (filters x pixels): the wrapper's TILES lists the same, in this order
template <int kCB>
int launch_cb(int tile, const void* x, const void* w, const void* sx, const void* sw,
              const void* bias, void* y, int mode, const Geometry& g, cudaStream_t s) {
  switch (tile) {
    case 1: return launch_tile<2, 4, 2, 4, kCB>(x, w, sx, sw, bias, y, mode, g, s);  // 64x128
    case 3: return launch_tile<1, 4, 2, 4, kCB>(x, w, sx, sw, bias, y, mode, g, s);  // 32x128
    case 4: return launch_tile<1, 4, 1, 4, kCB>(x, w, sx, sw, bias, y, mode, g, s);  // 16x128
    default: break;
  }
  if constexpr (kCB == 16) {
    switch (tile) {
      case 0: return launch_tile<2, 2, 4, 4, kCB>(x, w, sx, sw, bias, y, mode, g, s);  // 128x64
      case 2: return launch_tile<2, 2, 2, 4, kCB>(x, w, sx, sw, bias, y, mode, g, s);  // 64x64
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

int launch(const void* x, const void* w, const void* sx, const void* sw, const void* bias,
           void* y, int mode, const int* geo, void* stream) {
  const Geometry g{geo[0], geo[1], geo[2], geo[3], geo[4],  geo[5],
                   geo[6], geo[7], geo[8], geo[9], geo[10], geo[11]};
  const cudaStream_t s = (cudaStream_t)stream;
  if (g.cp % 16 == 0) return launch_cb<16>(geo[12], x, w, sx, sw, bias, y, mode, g, s);
  if (g.cp % 4 == 0) return launch_cb<4>(geo[12], x, w, sx, sw, bias, y, mode, g, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// geo: batch, H, W, Cp, C_out, kh, kw, Ho, Wo, stride, padding, dilation, tile index.
extern "C" int int8_conv_f32(const void* x, const void* w, const void* sx, const void* sw,
                             const void* bias, void* y, const int* geo, void* stream) {
  return launch(x, w, sx, sw, bias, y, kF32, geo, stream);
}

extern "C" int int8_conv_bf16(const void* x, const void* w, const void* sx, const void* sw,
                              const void* bias, void* y, const int* geo, void* stream) {
  return launch(x, w, sx, sw, bias, y, kBF16, geo, stream);
}

extern "C" int int8_conv_sums(const void* x, const void* w, void* y, const int* geo,
                              void* stream) {
  return launch(x, w, nullptr, nullptr, nullptr, y, kSums, geo, stream);
}
