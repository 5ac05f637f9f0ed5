// Area attention forward for Hopper (sm_90a): softmax(q k^T / sqrt(hd)) v
// inside each of `area` contiguous token chunks, per head, with head_dim 32.
//
// Replaces sar_yolo_tpu/ops/pallas/flash_attention.py::_flash_kernel (the TPU
// online-softmax kernel). It computes the same function; it is not a block-by-
// block copy of it: the TPU wrapper pads head_dim to 128 lanes and the chunk
// length to a multiple of 128 and folds (B, N, C) into (B*area*H, Na, hd) with
// transposes. Here q, k and v are read in place through their strides, the
// area and head offsets come from the grid indices, and the ragged last key
// tile is masked instead of padded.
//
// Design (simple, CUDA cores, f32 arithmetic):
//   * one thread block = one (sequence b*area, head, 32-query tile), 4 warps;
//   * every warp holds the same 32 queries, one per lane: 32 q values and
//     a 32-wide f32 accumulator in registers, and runs an
//     online softmax over its own quarter of the keys (key split);
//   * the block stages 4 x 32 keys of K and V at a time through shared memory
//     as f32, channel-major per warp ([32][32+4]), 36 KB; all threads of a
//     warp read the same float4 (a broadcast);
//   * at the end the 4 partial (max, sum, accumulator) per query are merged
//     through shared memory and the output, cast to the input dtype, is
//     written through its strides.
//
// Bound at the slice's shapes (yolov13n-JDE @640: Na = 400, (B*area*H) = 8B at
// P4 and 4B at P5; JDE_P24 @1280: Na = 1600). Per call:
//   FLOPs = 4 * (B*area*H) * Na^2 * hd      (q k^T and p v, 2 FLOPs per MAC)
//   bytes = 4 * B * N * C * itemsize        (read q, k, v once, write o once)
// which is Na/4 FLOP per byte in f32 and Na/2 in bf16. Against the H100's
// f32 CUDA-core rate (67 TFLOP/s over 3.35 TB/s: 20 FLOP/byte) every call is
// bound by operations; against the bf16 tensor-core rate (295 FLOP/byte) the
// Na = 400 calls are bound by bytes and the Na = 1600 calls by operations.
// The design keeps the score matrix out of device memory, so its bytes stay at
// that floor; its products run on CUDA cores in f32, so its ceiling is the f32
// CUDA-core rate. The key split gives 4 warps per 32 queries, so batch 1 at P4
// still launches only 104 blocks. Tensor-core products (mma/wgmma), TMA
// staging and a persistent grid are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int HD = 32;         // head dim (A2C2f: num_heads = c_ / 32)
constexpr int TQ = 32;         // queries per block: one per lane
constexpr int KS = 4;          // key splits: warps per block
constexpr int TK = 32;         // keys per warp per step
constexpr int NT = TQ * KS;    // threads per block
constexpr int PITCH = TK + 4;  // row pitch of the channel-major tiles (16-byte aligned)
static_assert(NT == KS * TK, "one staged key per thread and channel row");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  long long b, n, c;  // elements between neighbours along batch, token, channel
};

// Stage keys [base, base + KS*TK) of one (batch, head) slice into tile[KS][HD][PITCH].
template <typename T>
__device__ __forceinline__ void stage(float (*tile)[HD][PITCH], const T* __restrict__ src,
                                      Strides s, int base, int na) {
  if (s.n == 1) {  // token-contiguous (NCHW maps viewed as (B, N, C)): thread = key
    const int key = base + threadIdx.x;
    const bool ok = key < na;
#pragma unroll 8  // 8 loads in flight per thread; a full unroll spills registers
    for (int d = 0; d < HD; ++d)
      tile[threadIdx.x / TK][d][threadIdx.x % TK] =
          ok ? to_f32(src[(long long)key * s.n + (long long)d * s.c]) : 0.f;
  } else {  // channel-contiguous: neighbouring threads take neighbouring channels
#pragma unroll 8
    for (int r = 0; r < HD; ++r) {
      const int i = threadIdx.x + r * NT;
      const int key = i / HD, d = i % HD;
      tile[key / TK][d][key % TK] =
          base + key < na ? to_f32(src[(long long)(base + key) * s.n + (long long)d * s.c]) : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_area_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            int area, int na, float scale,
                            Strides qs, Strides ks, Strides vs, Strides os) {
  __shared__ __align__(16) float k_tile[KS][HD][PITCH];
  __shared__ __align__(16) float v_tile[KS][HD][PITCH];

  const int lane = threadIdx.x % TQ;
  const int warp = threadIdx.x / TQ;
  const int seq = blockIdx.z;            // b * area + a
  const int b = seq / area;
  const int tok0 = (seq % area) * na;    // first token of this area chunk
  const int ch0 = blockIdx.y * HD;       // first channel of this head
  const int qi = blockIdx.x * TQ + lane;  // query index inside the chunk
  const bool q_valid = qi < na;

  float qr[HD];
  float acc[HD];
  const T* qp = q + b * qs.b + (long long)(tok0 + qi) * qs.n + (long long)ch0 * qs.c;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = q_valid ? to_f32(qp[d * qs.c]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const T* kb = k + b * ks.b + (long long)tok0 * ks.n + (long long)ch0 * ks.c;
  const T* vb = v + b * vs.b + (long long)tok0 * vs.n + (long long)ch0 * vs.c;

  for (int base = 0; base < na; base += KS * TK) {
    __syncthreads();  // the previous tiles are no longer read
    stage(k_tile, kb, ks, base, na);
    stage(v_tile, vb, vs, base, na);
    __syncthreads();
    const int nk = min(TK, na - base - warp * TK);  // keys of this warp's sub-tile
    if (nk <= 0) continue;                          // warp-uniform

    float s[TK];
#pragma unroll
    for (int j = 0; j < TK; ++j) s[j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < TK; j += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_tile[warp][d][j]);
        s[j] = fmaf(qd, kk.x, s[j]);
        s[j + 1] = fmaf(qd, kk.y, s[j + 1]);
        s[j + 2] = fmaf(qd, kk.z, s[j + 2]);
        s[j + 3] = fmaf(qd, kk.w, s[j + 3]);
      }
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      // scale after the dot, as the plain version does: the same rounding of
      // the logits, whose error the softmax multiplies by their magnitude
      s[j] = j < nk ? s[j] * scale : -INFINITY;  // ragged tail of the chunk
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);  // finite: nk > 0
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < TK; j += 4) {  // 32 independent accumulator chains
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_tile[warp][d][j]);
        acc[d] = fmaf(s[j], vv.x, acc[d]);
        acc[d] = fmaf(s[j + 1], vv.y, acc[d]);
        acc[d] = fmaf(s[j + 2], vv.z, acc[d]);
        acc[d] = fmaf(s[j + 3], vv.w, acc[d]);
      }
    }
  }

  // merge the KS partial softmaxes of each query; warp w then writes dims [8w, 8w+8)
  constexpr int ROW = HD + 2;
  static_assert(KS * TQ * ROW <= KS * HD * PITCH, "merge buffer fits in k_tile");
  float* part = &k_tile[0][0][0];
  __syncthreads();
  float* mine = part + (warp * TQ + lane) * ROW;
  mine[0] = m;
  mine[1] = l;
#pragma unroll
  for (int d = 0; d < HD; ++d) mine[2 + d] = acc[d];
  __syncthreads();
  if (!q_valid) return;
  float mg[KS], big = -INFINITY;
#pragma unroll
  for (int g = 0; g < KS; ++g) {
    mg[g] = part[(g * TQ + lane) * ROW];
    big = fmaxf(big, mg[g]);
  }
  float wg[KS], total = 0.f;
#pragma unroll
  for (int g = 0; g < KS; ++g) {
    wg[g] = expf(mg[g] - big);  // 0 for a warp that saw no key
    total += wg[g] * part[(g * TQ + lane) * ROW + 1];
  }
  const float inv = 1.f / total;
  constexpr int DW = HD / KS;
  T* op = o + b * os.b + (long long)(tok0 + qi) * os.n + (long long)ch0 * os.c;
#pragma unroll
  for (int dd = 0; dd < DW; ++dd) {
    const int d = warp * DW + dd;
    float x = 0.f;
#pragma unroll
    for (int g = 0; g < KS; ++g) x += wg[g] * part[(g * TQ + lane) * ROW + 2 + d];
    store(op + d * os.c, x * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int n_tokens,
           int area, int heads, const long long* st, void* stream) {
  const int na = n_tokens / area;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((na + TQ - 1) / TQ, heads, batch * area);
  flash_area_attention_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), area, na, static_cast<float>(1.0 / sqrt(static_cast<double>(HD))),
      qs, ks, vs, os);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. q, k, v, o are (batch, n_tokens, heads*32)
// tensors addressed through `strides` (12 values: batch, token and channel
// strides in elements of q, k, v, o). Launches on `stream`, allocates nothing,
// returns cudaGetLastError() after the launch.
extern "C" int flash_area_attention_f32(const void* q, const void* k, const void* v, void* o,
                                        int batch, int n_tokens, int area, int heads,
                                        const long long* strides, void* stream) {
  return launch<float>(q, k, v, o, batch, n_tokens, area, heads, strides, stream);
}

extern "C" int flash_area_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                         int batch, int n_tokens, int area, int heads,
                                         const long long* strides, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, batch, n_tokens, area, heads, strides, stream);
}
