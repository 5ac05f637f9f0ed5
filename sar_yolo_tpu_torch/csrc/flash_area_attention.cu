// Area attention forward for Hopper (sm_90a): softmax(q k^T / sqrt(hd)) v
// inside each of `area` contiguous token chunks, per head, with head_dim 32.
//
// Replaces sar_yolo_tpu/ops/pallas/flash_attention.py::_flash_kernel (line 29,
// the TPU online-softmax kernel). It computes the same function; it is not a
// block-by-block copy of it: the TPU wrapper pads head_dim to 128 lanes and the
// chunk length to a multiple of 128 and folds (B, N, C) into (B*area*H, Na, hd)
// with transposes. Here q, k and v are read in place through their strides, the
// area and head offsets come from the grid indices, and the ragged last key
// tile is masked instead of padded.
//
// Bound. Per call, FLOPs = 4 * (B*area*H) * Na^2 * hd (q k^T and p v) and
// bytes = 4 * B * N * C * itemsize (q, k, v read once, o written once): Na/4
// FLOP per byte in f32, Na/2 in bf16. Every product runs on the tensor cores:
//   * float32: split TF32 (3xTF32). x = hi + lo with hi = tf32(x) and
//     lo = tf32(x - hi); a*b ~ lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, summed in f32.
//     One TF32 pass would lose the 1e-4 agreement with float32 at Na = 400;
//     three keep float32's own error. The f32 peak is thus 495/3 TFLOP/s, and
//     against 3.35 TB/s every f32 call at Na >= 400 is bound by operations.
//   * bfloat16: one bf16 pass, f32 accumulation (989 TFLOP/s); Na = 400 calls
//     are bound by bytes, Na = 1600 calls by operations.
// The score matrix never leaves registers, so bytes stay at their floor.
//
// Design:
//   * mma.sync (m16n8k8 tf32, m16n8k16 bf16), not wgmma: a warpgroup tile is
//     64 query rows (too few tiles at batch 1), the products are only 32 deep,
//     and TF32 wgmma wants K-major operands, which token-contiguous K is not.
//   * a warp owns 16 query rows (its Q fragments, split once into hi/lo, stay
//     in registers); a block has 8 warps and stages 128 keys at a time, as
//     four 32-key shares. Small grids (batch 1) give each query tile 4 warps,
//     one share of every stage each, and merge their (max, sum, accumulator)
//     states through shared memory at the end: the key split keeps the card
//     busy. Larger grids give a tile 2 warps or 1, and a block 4 or 8 tiles:
//     fewer stagings of K and V per query (launch plan: plan() below).
//   * p v of each share goes into a fresh accumulator that is then added,
//     rounded, to the running one: the tensor cores truncate the sums they
//     accumulate, and one chain over a whole chunk biased the output.
//   * K and V are staged channel-major [d][key] with a row pitch of 136
//     elements (8 mod 32 f32 words: the tf32 B-fragment reads of K and the
//     8-byte reads of V at keys 2t, 2t+1 are free of bank conflicts; 4 mod 32
//     bf16 words: ldmatrix rows are too), two stages deep with cp.async, so the
//     next stage's copies overlap this stage's products; one barrier a stage.
//     Token-contiguous
//     inputs copy 16 bytes at a time, or 8 or 4 where the chunk starts are
//     less aligned (imgsz 480: Na = 225); other layouts stage element by
//     element through registers. The products are the same on every path.
//   * tf32 P v needs no shuffle: a thread holds score columns 2t, 2t+1, and
//     the k index of p v is taken as a permutation of the 8 keys
//     (a0 = c0, a1 = c2, a2 = c1, a3 = c3; V read at keys 2t and 2t+1).
//   * softmax in f32 registers: ex2.approx, with log2(e) folded into the scale
//     and the scale into one FFMA per score.
//
// Measured (H100 SXM, PERF.md): 6-16x the bound above. With 16 query rows a
// warp, a 32-key share runs a few hundred instructions, of which 16 (bf16) or
// 96 (f32) are mma, and at 2 warps a scheduler the warps stall on that chain.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 32;             // head dim (A2C2f: num_heads = c_ / 32)
constexpr int TQ = 16;             // query rows per warp (mma M)
constexpr int TK = 32;             // keys of one share
constexpr int SHARES = 4;          // 32-key shares per stage
constexpr int BK = SHARES * TK;    // keys per stage
constexpr int PITCH = BK + 8;      // row pitch of the [d][key] tiles, in elements
constexpr int STAGES = 2;
constexpr int ROW = HD + 2;        // merge record of one query row: m, l, o[32]
constexpr int WARPS = 8;           // warps per block
constexpr int SMS = 132;           // H100 SXM
static_assert(PITCH % 32 == 8, "f32 pitch must be 8 mod 32 words");

struct Strides {
  long long b, n, c;  // elements between neighbours along batch, token, channel
};

// ---- PTX wrappers -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// W-byte async copy of src_bytes (<= W, the rest zero-filled) into shared memory
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(W), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// 2^x by the SFU (MUFU.EX2): exp2f's own approximation, without its fix-up of
// results below 2^-126, which flush to 0 here (weights that small add nothing)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo, both tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a * b in split TF32: the two small terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ahi, const uint32_t* alo,
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_tf32(c, alo, bh0, bh1);
  mma_tf32(c, ahi, bl0, bl1);
  mma_tf32(c, ahi, bh0, bh1);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// (lo, hi) -> one register, lo in the low half (the lower k index of a fragment pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ---- staging of one 128-key stage of K or V into tile[HD][PITCH] ---------

// Token-contiguous source (s.n == 1), W-byte copies; keys past na are zero.
template <typename T, int W>
__device__ __forceinline__ void stage_async(T* tile, const T* src, Strides s, int base, int na) {
  constexpr int E = W / static_cast<int>(sizeof(T));  // elements per copy
  constexpr int PER_ROW = BK / E;
#pragma unroll 4
  for (int i = threadIdx.x; i < HD * PER_ROW; i += blockDim.x) {
    const int d = i / PER_ROW, key = (i % PER_ROW) * E;
    const int valid = min(max(na - base - key, 0), E);
    const T* p = valid > 0 ? src + (long long)(base + key) + (long long)d * s.c : src;
    cp_async<W>(tile + d * PITCH + key, p, valid * static_cast<int>(sizeof(T)));
  }
}

// Any strides, element by element; neighbouring threads take neighbouring
// addresses along whichever of the token and channel axes is contiguous.
template <typename T>
__device__ __forceinline__ void stage_sync(T* tile, const T* src, Strides s, int base, int na) {
  const bool tok = s.n == 1;
#pragma unroll 8
  for (int i = threadIdx.x; i < HD * BK; i += blockDim.x) {
    const int key = tok ? i % BK : i / HD, d = tok ? i / BK : i % HD;
    tile[d * PITCH + key] =
        base + key < na ? src[(long long)(base + key) * s.n + (long long)d * s.c] : zero<T>();
  }
}

template <typename T, int W>
__device__ __forceinline__ void stage(T* tile, const T* src, Strides s, int base, int na) {
  if constexpr (W == 0)
    stage_sync(tile, src, s, base, na);
  else
    stage_async<T, W>(tile, src, s, base, na);
}

// ---- products of one warp: 16 query rows x 32 keys ------------------------
// Fragment coordinates: g = lane / 4 (row, or B column), t = lane % 4.
// Scores s[n][c]: key tile n (8 keys), c0 = (g, 2t), c1 = (g, 2t+1),
// c2 = (g+8, 2t), c3 = (g+8, 2t+1). The accumulator o[n][c] is the same with
// n a tile of 8 channels.

template <typename T> struct QFrag;

template <> struct QFrag<float> {  // 4 k-steps of 8 channels, split once
  uint32_t hi[4][4], lo[4][4];
  __device__ __forceinline__ void load(const float* qp, Strides s, int q0, int na, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
        const int row = q0 + g + 8 * (r & 1), d = kk * 8 + t + 4 * (r >> 1);
        const float x = row < na ? qp[(long long)row * s.n + (long long)d * s.c] : 0.f;
        split(x, hi[kk][r], lo[kk][r]);
      }
  }
};

template <> struct QFrag<__nv_bfloat16> {  // 2 k-steps of 16 channels
  uint32_t a[2][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* qp, Strides s, int q0, int na, int g,
                                       int t) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // a0a1 (g, 2t..), a2a3 (g+8, 2t..), a4a5 (g, 2t+8..), a6a7
        const int row = q0 + g + 8 * (r & 1), d = kk * 16 + 2 * t + 8 * (r >> 1);
        __nv_bfloat16 x0 = zero<__nv_bfloat16>(), x1 = x0;
        if (row < na) {
          const __nv_bfloat16* p = qp + (long long)row * s.n + (long long)d * s.c;
          x0 = p[0];
          x1 = p[s.c];
        }
        a[kk][r] = pack_bf16(x0, x1);
      }
  }
};

// s = q k^T over 32 keys; K is the stage tile offset to the first of them
__device__ __forceinline__ void scores(float (*s)[4], const QFrag<float>& q, const float* K,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int n = 0; n < 4; ++n) {  // b0 = K[key 8n+g][d 8kk+t], b1 = d + 4
      uint32_t h0, l0, h1, l1;
      split(K[(kk * 8 + t) * PITCH + n * 8 + g], h0, l0);
      split(K[(kk * 8 + t + 4) * PITCH + n * 8 + g], h1, l1);
      mma_3xtf32(s[n], q.hi[kk], q.lo[kk], h0, h1, l0, l1);
    }
}

__device__ __forceinline__ void scores(float (*s)[4], const QFrag<__nv_bfloat16>& q,
                                       const __nv_bfloat16* K, int lane) {
  // ldmatrix.trans of [d][key]: matrices (d 0-7, keys 0-7), (d 8-15, keys 0-7),
  // (d 0-7, keys 8-15), (d 8-15, keys 8-15) give b0b1, b2b3 of two key tiles
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, K + (kk * 16 + row) * PITCH + np * 16 + col);
      mma_bf16(s[2 * np], q.a[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], q.a[kk], b[2], b[3]);
    }
}

// o += p v over 32 keys
__device__ __forceinline__ void pv(float (*o)[4], float (*p)[4], const float* V, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // k-step j = key tile j; k index t <-> key 2t, t+4 <-> 2t+1
    uint32_t ah[4], al[4];
    split(p[j][0], ah[0], al[0]);
    split(p[j][2], ah[1], al[1]);
    split(p[j][1], ah[2], al[2]);
    split(p[j][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {  // b0 = V[key 8j+2t][d 8n+g], b1 = key + 1
      const float2 b = *reinterpret_cast<const float2*>(V + (n * 8 + g) * PITCH + j * 8 + 2 * t);
      uint32_t h0, l0, h1, l1;
      split(b.x, h0, l0);
      split(b.y, h1, l1);
      mma_3xtf32(o[n], ah, al, h0, h1, l0, l1);
    }
  }
}

__device__ __forceinline__ void pv(float (*o)[4], float (*p)[4], const __nv_bfloat16* V,
                                   int lane) {
  // ldmatrix of [d][key]: matrices (d 0-7, keys 0-7), (d 0-7, keys 8-15),
  // (d 8-15, keys 0-7), (d 8-15, keys 8-15) give b0b1, b2b3 of two channel tiles
  const int row = (lane & 7) + (lane >> 4) * 8, col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // k-step j: keys 16j..16j+15 = score tiles 2j, 2j+1
    const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]), pack_bf16(p[2 * j][2], p[2 * j][3]),
                           pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, V + (np * 16 + row) * PITCH + j * 16 + col);
      mma_bf16(o[2 * np], a, b[0], b[1]);
      mma_bf16(o[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// One step of the online softmax of a warp: its 16 query rows against the
// nk <= 32 keys of one share (K and V: the stage tiles offset to the share).
template <typename T>
__device__ __forceinline__ void attend(const QFrag<T>& qf, const T* K, const T* V, int nk,
                                       float scale_log2, int lane, float* m, float* l,
                                       float (*acc)[4]) {
  float s[4][4] = {};
  scores(s, qf, K, lane);
  if (nk < TK) {  // the ragged tail of the chunk (warp-uniform)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (n * 8 + 2 * (lane & 3) + (c & 1) >= nk) s[n][c] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // row max over the quad; finite: nk > 0
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);  // m in scaled log2 units
    alpha[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // the logits scaled after the dot, as the plain version does, in one FFMA
      s[n][c] = exp2_approx(fmaf(s[n][c], scale_log2, -m[c >> 1]));
      l[c >> 1] += s[n][c];  // this thread's columns; summed over the quad at the end
    }
  // p v of these keys into a fresh accumulator, then one rounded f32 add: the
  // tensor cores truncate the sums they accumulate, and one chain over a whole
  // chunk biased the output toward zero
  float pv_tile[4][4] = {};
  pv(pv_tile, s, V, lane);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = fmaf(acc[n][c], alpha[c >> 1], pv_tile[n][c]);
}

// ---- the kernel ------------------------------------------------------------
// grid (query blocks, heads, B*area); blockDim = 32 * query tiles * splits.
// Warp w takes query tile w / splits and, of every stage, the 32-key shares
// w % splits, w % splits + splits, ...: splits = 4 gives each warp one share
// (the key split, for small grids), splits = 1 all four.

template <typename T, int W>
__global__ void __launch_bounds__(32 * WARPS, 2)
flash_area_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o, int area, int na,
                            int splits, float scale_log2, Strides qs, Strides ks, Strides vs,
                            Strides os) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const tiles = reinterpret_cast<T*>(smem);  // [STAGES][K, V][HD][PITCH]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qtile = warp / splits, split_id = warp % splits;
  const int seq = blockIdx.z;          // b * area + a
  const int b = seq / area;
  const int tok0 = (seq % area) * na;  // first token of this area chunk
  const int ch0 = blockIdx.y * HD;     // first channel of this head
  const int q0 = (blockIdx.x * (blockDim.x / (32 * splits)) + qtile) * TQ;  // warp's first query

  QFrag<T> qf;
  qf.load(q + b * qs.b + (long long)tok0 * qs.n + (long long)ch0 * qs.c, qs, q0, na, lane >> 2,
          lane & 3);
  float acc[4][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8

  const T* kb = k + b * ks.b + (long long)tok0 * ks.n + (long long)ch0 * ks.c;
  const T* vb = v + b * vs.b + (long long)tok0 * vs.n + (long long)ch0 * vs.c;
  const int n_stages = (na + BK - 1) / BK;
  // STAGES - 1 stages of copies stay in flight ahead of the products
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < n_stages) {
      stage<T, W>(tiles + it * 2 * HD * PITCH, kb, ks, it * BK, na);
      stage<T, W>(tiles + (it * 2 + 1) * HD * PITCH, vb, vs, it * BK, na);
    }
    cp_commit();
  }
  for (int it = 0; it < n_stages; ++it) {
    cp_wait<STAGES - 2>();  // stage it has landed
    __syncthreads();        // ... for every thread, and stage it - 1 is no longer read
    const int ahead = it + STAGES - 1;
    if (ahead < n_stages) {  // into the buffer of stage it - 1
      T* next = tiles + (ahead % STAGES) * 2 * HD * PITCH;
      stage<T, W>(next, kb, ks, ahead * BK, na);
      stage<T, W>(next + HD * PITCH, vb, vs, ahead * BK, na);
    }
    cp_commit();
    const T* K = tiles + (it % STAGES) * 2 * HD * PITCH;
    const int base = it * BK;
    for (int share = split_id; share < SHARES; share += splits) {
      const int nk = min(TK, na - base - share * TK);  // keys of this share
      if (nk <= 0) break;                              // warp-uniform
      attend(qf, K + share * TK, K + HD * PITCH + share * TK, nk, scale_log2, lane, m, l, acc);
    }
  }
  cp_wait<0>();
  __syncthreads();  // the stage buffers become the merge buffer

  // merge the partial softmaxes of each query row's warps through shared memory
  float* const part = reinterpret_cast<float*>(smem);  // [query tile][split][TQ][ROW]
  float* const mine = part + warp * TQ * ROW;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (t == 0) {
      mine[(g + 8 * r) * ROW] = m[r];
      mine[(g + 8 * r) * ROW + 1] = l[r];
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      mine[(g + 8 * (c >> 1)) * ROW + 2 + n * 8 + 2 * t + (c & 1)] = acc[n][c];
  __syncthreads();

  const float* const grp = part + qtile * splits * TQ * ROW;
  T* const ob = o + b * os.b + (long long)tok0 * os.n + (long long)ch0 * os.c;
  const bool tok_major = os.n == 1;  // neighbouring threads write neighbouring addresses
  for (int i = split_id * 32 + lane; i < TQ * HD; i += 32 * splits) {
    const int row = tok_major ? i % TQ : i / HD, d = tok_major ? i / TQ : i % HD;
    const int qi = q0 + row;
    if (qi >= na) continue;
    float big = -INFINITY;
    for (int w = 0; w < splits; ++w) big = fmaxf(big, grp[(w * TQ + row) * ROW]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < splits; ++w) {
      const float* rec = grp + (w * TQ + row) * ROW;
      const float wt = exp2_approx(rec[0] - big);  // 0 for a warp that saw no key
      den += wt * rec[1];
      num += wt * rec[2 + d];
    }
    store(ob + (long long)qi * os.n + (long long)d * os.c, num / den);
  }
}

// ---- launch geometry (mirrored by ops/cuda/flash_attention.py::launch_geometry)

struct Plan {
  int grid_x, grid_y, grid_z, warps, splits, stage_bytes, smem_bytes;
};

Plan plan(const void* k, const void* v, int itemsize, int batch, int n_tokens, int area,
          int heads, const long long* st) {
  const int na = n_tokens / area;
  // widest cp.async copy that every 16-byte chunk start of K and V allows; 0: element copies
  auto fits = [&](const void* p, const long long* s, int w) {
    return s[1] == 1 && reinterpret_cast<uintptr_t>(p) % w == 0 && s[0] * itemsize % w == 0 &&
           s[2] * itemsize % w == 0 && (long long)na * itemsize % w == 0;
  };
  constexpr int widths[] = {16, 8, 4};
  int stage_bytes = 0;
  for (int w : widths)
    if (fits(k, st + 3, w) && fits(v, st + 6, w)) {
      stage_bytes = w;
      break;
    }
  const int q_tiles = (na + TQ - 1) / TQ;
  // 8 warps a block. The more query tiles there are, the more of them a
  // block takes (fewer K/V stagings per query) and the fewer warps split
  // one tile's keys; small grids split each tile's keys over 4 warps.
  const long long tiles = (long long)q_tiles * heads * batch * area;
  const int splits = tiles >= 6LL * SMS ? 1 : tiles >= 2LL * SMS ? 2 : 4;
  const int qt = WARPS / splits;
  const int stage_smem = STAGES * 2 * HD * PITCH * itemsize;
  const int merge_smem = qt * splits * TQ * ROW * static_cast<int>(sizeof(float));
  return {(q_tiles + qt - 1) / qt, heads, batch * area, qt * splits, splits, stage_bytes,
          stage_smem > merge_smem ? stage_smem : merge_smem};
}

template <typename T, int W>
int run(const Plan& p, const void* q, const void* k, const void* v, void* o, int area, int na,
        const long long* st, void* stream) {
  auto kernel = flash_area_attention_kernel<T, W>;
  if (p.smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(HD)));
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  kernel<<<dim3(p.grid_x, p.grid_y, p.grid_z), 32 * p.warps, p.smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), area, na, p.splits, scale_log2, qs, ks, vs, os);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int n_tokens,
           int area, int heads, const long long* st, void* stream) {
  const Plan p = plan(k, v, sizeof(T), batch, n_tokens, area, heads, st);
  const int na = n_tokens / area;
  switch (p.stage_bytes) {
    case 16: return run<T, 16>(p, q, k, v, o, area, na, st, stream);
    case 8: return run<T, 8>(p, q, k, v, o, area, na, st, stream);
    case 4: return run<T, 4>(p, q, k, v, o, area, na, st, stream);
    default: return run<T, 0>(p, q, k, v, o, area, na, st, stream);
  }
}

template <typename T>
const void* kernel_of(int stage_bytes) {
  switch (stage_bytes) {
    case 16: return reinterpret_cast<const void*>(flash_area_attention_kernel<T, 16>);
    case 8: return reinterpret_cast<const void*>(flash_area_attention_kernel<T, 8>);
    case 4: return reinterpret_cast<const void*>(flash_area_attention_kernel<T, 4>);
    default: return reinterpret_cast<const void*>(flash_area_attention_kernel<T, 0>);
  }
}

}  // namespace

// C interface, bound with ctypes. q, k, v, o are (batch, n_tokens, heads*32)
// tensors addressed through `strides` (12 values: batch, token and channel
// strides in elements of q, k, v, o). Launches on `stream`, allocates nothing,
// returns cudaGetLastError() after the launch (or the error of raising the
// dynamic shared-memory limit).
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

// The launch geometry the two functions above would use, into out[7]: grid x,
// y, z, warps per block, key splits per query tile, staging copy bytes (16, 8, 4; 0 = element copies),
// dynamic shared-memory bytes. For checking the wrapper's mirror of it.
extern "C" void flash_area_attention_plan(const void* k, const void* v, int itemsize, int batch,
                                          int n_tokens, int area, int heads,
                                          const long long* strides, int* out) {
  const Plan p = plan(k, v, itemsize, batch, n_tokens, area, heads, strides);
  const int vals[7] = {p.grid_x,      p.grid_y,      p.grid_z,    p.warps,
                       p.splits,      p.stage_bytes, p.smem_bytes};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
}

// Resident blocks per SM of the kernel that a plan with these values launches
// (-1 if the occupancy query fails).
extern "C" int flash_area_attention_blocks_per_sm(int itemsize, int stage_bytes, int warps,
                                                  int smem_bytes) {
  const void* fn = itemsize == 4 ? kernel_of<float>(stage_bytes)
                                 : kernel_of<__nv_bfloat16>(stage_bytes);
  if (smem_bytes > 48 * 1024 &&
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes) !=
          cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, 32 * warps, smem_bytes) !=
      cudaSuccess)
    return -1;
  return blocks;
}
