// Per-sample symmetric int8 quantization of an NCHW activation for Hopper (sm_90a), written
// as int8_conv.cu's NHWC operand: one cooperative launch, two phases.
//
// Replaces no TPU kernel: the JAX package quantizes with XLA ops in
// sar_yolo_tpu/nn/modules/conv.py::Int8Conv2D (lines 119-120): sx = max(max|x|, 1e-12) / 127
// over each sample's (H, W, C), xq = clip(round(x / sx), -127, 127). The port's plain
// version (ops/cuda/int8_conv.py::int8_quantize_plain) is eight torch launches, each over
// the whole activation in float32; this is one.
//
// Function. x float32 or bf16 (B, C, H, W), each sample's C planes contiguous (a channel
// slice of a larger tensor too: the samples' stride is an argument); out: sx (B,) float32
// and xq int8 (B, H, W, Cp), channels C..Cp-1 zero. Bit for bit the plain version: IEEE
// division (__fdiv_rn, not a reciprocal; the build has no --use_fast_math), rintf's round half
// to even (torch.round's and jnp.round's), bf16 widened exactly.
//
// Bound: bytes. The input read once and xq written once: B*C*H*W*itemsize + B*H*W*Cp bytes
// over 3.35 TB/s. The abs-max needs all of a sample before its first value can be quantized,
// so the kernel reads the input twice; the second read hits the 50 MB L2 where a layer's
// input fits there (running the phases a few samples at a time, a barrier each, to keep a
// larger input in L2 measured slower on yolov13-JDE's shapes).
//
// Design. The grid is at most what the card holds at once (cudaLaunchCooperativeKernel), so
// the two phases meet at a grid-wide barrier instead of a second launch: most of the int8
// path's calls are small, and a launch costs the host and the card a few microseconds each.
// * Phase 1: the grid strides over (sample, slice) units; a block reduces its slice with
//   16-byte loads (four in flight a thread) where the sample is aligned, and writes the
//   slice's max to partial[]. No atomics, no zeroed buffer: nothing to clear between calls.
// * grid.sync(); then every block reduces the partials (at most 256 a sample, from L2) of
//   every sample to sx in shared memory, as the plain version computes it; block 0 writes sx.
// * Phase 2: the grid strides over tiles of 4096 values (64 channels x 64 pixels, or Cp x
//   4096 / Cp for Cp of 4 to 32) of one sample: each is read along the pixels of its channel
//   planes (coalesced NCHW reads, four pixels a load where HW % 4 == 0), quantized in
//   registers, transposed through shared memory (a 4x4 byte shuffle among the lanes of a
//   channel quad, then one word a lane) and written along the channels of each pixel
//   (16-byte NHWC stores where the tile's bytes a pixel are a multiple of 16, 4-byte ones at
//   the stem's Cp = 4).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;  // values of one pass-2 tile

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 bytes of T as floats, their largest magnitude
__device__ __forceinline__ float abs_max16(const float4& v, float) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}
__device__ __forceinline__ float abs_max16(const float4& v, __nv_bfloat16) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(__bfloat162float(h[i])));
  return m;
}

// four neighbouring values as floats: one 16-byte (float32) or 8-byte (bf16) load
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&a.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&a.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

// clip(round(v / s), -127, 127): IEEE division, round half to even
__device__ __forceinline__ unsigned char quantize(float v, float s) {
  return (unsigned char)(int8_t)(int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

struct Args {
  int batch, C, HW, Cp;
  int parts;        // abs-max slices a sample
  long long slice;  // values a slice (a multiple of 16 / sizeof(T) where vec)
  int vec;          // 16-byte loads in phase 1: each sample's start and size aligned
  int ct;           // channels of a tile (Cp where Cp is 4, 8, 16 or 32, else 64)
  int vec4;         // HW % 4 == 0 and x aligned: four neighbouring pixels load as one
  long long sample_stride;  // in values: C * HW where x is contiguous
};

// the largest magnitude in values [lo, hi) of one sample, over the block
template <typename T>
__device__ float block_abs_max(const T* __restrict__ xs, long long lo, long long hi, int vec,
                               float* warps) {
  float m = 0.f;
  if (vec) {  // four 16-byte loads in flight a thread
    constexpr int kV = 16 / sizeof(T);
    const float4* v = reinterpret_cast<const float4*>(xs);
    const long long n = hi / kV;
    long long i = lo / kV + threadIdx.x;
    for (; i + 3 * kThreads < n; i += 4 * kThreads) {
      const float4 v0 = __ldg(v + i), v1 = __ldg(v + i + kThreads),
                   v2 = __ldg(v + i + 2 * kThreads), v3 = __ldg(v + i + 3 * kThreads);
      m = fmaxf(m, fmaxf(fmaxf(abs_max16(v0, T()), abs_max16(v1, T())),
                         fmaxf(abs_max16(v2, T()), abs_max16(v3, T()))));
    }
    for (; i < n; i += kThreads) m = fmaxf(m, abs_max16(__ldg(v + i), T()));
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) m = fmaxf(m, fabsf(widen(xs[i])));
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max(threadIdx.x < 32 && threadIdx.x < kThreads / 32 ? warps[threadIdx.x] : 0.f);
  __syncthreads();  // warps[] is free again
  return m;
}

// one tile: pixels [p0, p0 + kTile / ct) and channels [c0, c0 + ct) of one sample
template <typename T>
__device__ void quantize_tile(const T* __restrict__ xb, int8_t* __restrict__ qb, float s,
                              int c0, int p0, const Args& a, unsigned char* tile) {
  const int tid = threadIdx.x, ct = a.ct, C = a.C, HW = a.HW, Cp = a.Cp;
  // a row's words: odd for ct >= 8, so a warp's stores along the pixels meet no bank twice
  const int pt = kTile / ct, pitch = ct >= 8 ? ct + 4 : ct;
  const int cw = Cp - c0 < ct ? Cp - c0 : ct;  // bytes a pixel this tile writes
  if (a.vec4) {
    // a thread loads four pixels of one plane (all its loads in flight before the first
    // division); the four lanes of a channel quad then swap bytes, so that each holds one
    // pixel's four channels and stores them as one word
    constexpr int kGroups = kTile / 4 / kThreads;
    const int per_plane = pt / 4, k = tid & 3;
    float v[kGroups][4];
    bool in[kGroups];
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int rest = (tid + kThreads * i) >> 2, q = rest / per_plane;
      const int c = c0 + 4 * q + k, p = p0 + (rest - q * per_plane) * 4;
      in[i] = c < C && p < HW;
      if (in[i]) load4(xb + (long long)c * HW + p, v[i]);
    }
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int rest = (tid + kThreads * i) >> 2, q = rest / per_plane;
      const int px = (rest - q * per_plane) * 4;
      uint32_t mine = 0, word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) mine |= (uint32_t)(in[i] ? quantize(v[i][j], s) : 0) << (8 * j);
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const uint32_t u = __shfl_sync(0xffffffffu, mine, (tid & 28) | src);
        word |= ((u >> (8 * k)) & 0xffu) << (8 * src);
      }
      *reinterpret_cast<uint32_t*>(tile + (px + k) * pitch + 4 * q) = word;
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < kTile; e += kThreads) {
      const int cl = e / pt, px = e - cl * pt;
      const int c = c0 + cl, p = p0 + px;
      tile[px * pitch + cl] = c < C && p < HW ? quantize(widen(xb[(long long)c * HW + p]), s) : 0;
    }
  }
  __syncthreads();
  if (cw % 16 == 0) {
    const int chunks = cw / 16;
    for (int e = tid; e < pt * chunks; e += kThreads) {
      const int px = e / chunks, k = e - px * chunks, p = p0 + px;
      if (p >= HW) continue;
      const int* src = reinterpret_cast<const int*>(tile + px * pitch + 16 * k);
      *reinterpret_cast<int4*>(qb + (long long)p * Cp + c0 + 16 * k) =
          make_int4(src[0], src[1], src[2], src[3]);
    }
  } else {
    const int words = cw / 4;
    for (int e = tid; e < pt * words; e += kThreads) {
      const int px = e / words, k = e - px * words, p = p0 + px;
      if (p >= HW) continue;
      *reinterpret_cast<int*>(qb + (long long)p * Cp + c0 + 4 * k) =
          *reinterpret_cast<const int*>(tile + px * pitch + 4 * k);
    }
  }
  __syncthreads();  // the tile is free again
}

// dynamic shared memory: sx of every sample (batch floats)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    int8_quantize_kernel(const T* __restrict__ x, float* __restrict__ partial,
                         float* __restrict__ sx, int8_t* __restrict__ xq, Args a) {
  __shared__ __align__(16) unsigned char tile[kTile * 3 / 2];  // pt rows of `pitch` bytes
  __shared__ float warps[kThreads / 32];
  extern __shared__ float scales[];
  const long long per_sample = (long long)a.C * a.HW;
  for (int u = blockIdx.x; u < a.batch * a.parts; u += gridDim.x) {
    const int b = u / a.parts;
    const long long lo = (u - (long long)b * a.parts) * a.slice;
    const long long hi = lo + a.slice < per_sample ? lo + a.slice : per_sample;
    const float m = block_abs_max(x + b * a.sample_stride, lo, hi, a.vec, warps);
    if (threadIdx.x == 0) partial[u] = m;
  }
  cooperative_groups::this_grid().sync();
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < a.batch; b += kThreads / 32) {
    float m = 0.f;
    for (int i = lane; i < a.parts; i += 32) m = fmaxf(m, partial[b * a.parts + i]);
    m = warp_max(m);
    if (lane == 0) {
      const float s = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
      scales[b] = s;
      if (blockIdx.x == 0) sx[b] = s;
    }
  }
  __syncthreads();
  const int ptiles = (a.HW + kTile / a.ct - 1) / (kTile / a.ct), ctiles = (a.Cp + a.ct - 1) / a.ct;
  for (int t = blockIdx.x; t < a.batch * ctiles * ptiles; t += gridDim.x) {
    const int b = t / (ctiles * ptiles), r = t - b * ctiles * ptiles, c = r / ptiles;
    quantize_tile(x + b * a.sample_stride, xq + (long long)b * a.HW * a.Cp, scales[b], c * a.ct,
                  (r - c * ptiles) * (kTile / a.ct), a, tile);
  }
}

template <typename T>
int launch(const void* x, void* partial, void* sx, void* xq, const int* geo, void* stream) {
  // geo: B, C, HW, Cp, parts, slice, vec, ct, vec4, the samples' stride in values
  const Args a{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], geo[6], geo[7], geo[8], geo[9]};
  if (a.Cp % 4 != 0 || a.Cp < a.C || kTile % a.ct != 0 || a.ct % 4 != 0 || a.batch > 4096)
    return (int)cudaErrorInvalidValue;
  auto kernel = int8_quantize_kernel<T>;
  const size_t smem = (size_t)a.batch * sizeof(float);
  // blocks the card holds at once (computed once a device): the cooperative launch's limit
  static int resident[32] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int capacity = dev < 32 ? resident[dev] : 0;
  if (capacity == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        4096 * sizeof(float));
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    capacity = per_sm * sms;
    if (dev < 32) resident[dev] = capacity;
  }
  const long long tiles = (long long)a.batch * ((a.Cp + a.ct - 1) / a.ct) *
                          ((a.HW + kTile / a.ct - 1) / (kTile / a.ct));
  const long long units = (long long)a.batch * a.parts, work = tiles > units ? tiles : units;
  const int grid = (int)(work < capacity ? work : capacity);
  void* args[] = {(void*)&x, &partial, &sx, &xq, (void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), args, smem,
                                    (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" int int8_quantize_f32(const void* x, void* partial, void* sx, void* xq,
                                 const int* geo, void* stream) {
  return launch<float>(x, partial, sx, xq, geo, stream);
}

extern "C" int int8_quantize_bf16(const void* x, void* partial, void* sx, void* xq,
                                  const int* geo, void* stream) {
  return launch<__nv_bfloat16>(x, partial, sx, xq, geo, stream);
}
