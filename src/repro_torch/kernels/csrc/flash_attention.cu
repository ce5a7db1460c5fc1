// K2: flash-attention forward (prefill), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention_fwd).  Same function: q (B,Sq,Hq,hd),
// k/v (B,Skv,Hkv,hd), query head h reads kv head h / (Hq/Hkv); scores scaled
// by hd^-0.5, optional tanh softcap, causal and sliding-window masks over
// positions contiguous from 0; online softmax in f32; output in q's dtype.
// No Sq % tile requirement: ragged edges are masked here.
//
// What bounds it on the H100: at yi-9b's prefill (B 8, S 512, Hq 32, Hkv 4,
// hd 128, causal, bf16) one call does 4 * hd * B * Hq * S(S+1)/2 = 1.72e10
// FLOP, 17.4 us at 989 TFLOP/s, and must move q and o (33.5 MB each) plus k
// and v (4.2 MB each), 22.5 us at 3.35 TB/s: bytes, narrowly.  At
// recurrentgemma-9b's (B 8, S 2560, 16 q heads over 1 kv head, hd 256,
// window 2048) it does 4.1e11 FLOP, 0.42 ms: operations.  So the tensor
// cores must be fed from shared memory without stalls, and each CTA's fixed
// cost (q load, first tiles, epilogue) must hide behind other work: yi-9b's
// CTAs see only 1-8 kv tiles.
//
// Design, bf16 at hd 64-256 (the serving paths; flash_fwd_tma_kernel):
//  * a producer (one thread) issues TMA loads: q once, then k and v tiles of
//    64 keys into a ring of 2-3 stages, each stage with a full and an empty
//    mbarrier.  Tensor maps (cuTensorMapEncodeTiled, reached through
//    cudaGetDriverEntryPoint so the library needs no -lcuda) are passed as
//    __grid_constant__ parameters.  They are built on every call, 0.3 us of
//    host time for the four (chip_smoke.py times it).  Tiles land 128-byte
//    swizzled; v is used as loaded, with no transposed copy.
//  * consumer warpgroups of 64 query rows: S = Q.K^T by wgmma m64n64k16
//    with both operands from shared memory (K-major descriptors); the online
//    softmax in f32 registers (base 2), masking element-wise only the tiles
//    that cross the causal diagonal, the window edge or Skv; p rounded to
//    bf16 (as the plain version rounds its probabilities) and kept in
//    registers as wgmma's A operand; O += P.V by wgmma with V read MN-major
//    through its descriptor.  The kv loop runs from the window edge to the
//    causal edge, so wholly masked tiles are never loaded.
//  * hd 64 and 128: one consumer warpgroup and a producer warp (160
//    threads, 64 rows); two CTAs share an SM, so one's prologue and
//    epilogue overlap the other's products.  hd 256: the 64 x 256 f32 output
//    is 128 registers a thread, so two consumer warpgroups (128 rows) run
//    beside a producer warpgroup whose registers setmaxnreg hands over.
//  * q tiles with the most kv tiles launch first, so causal work balances.
//  * epilogue: the normalised tile is written into the warpgroup's own
//    (consumed) q rows in the swizzled layout and stored by TMA, which
//    clips rows past Sq.
// bf16 at hd 16 and 32 (smoke shapes only; flash_fwd_mma_kernel): rows under
//    128 B do not take this swizzle, so these stay on mma.sync m16n8k16 with
//    plain staged loads, a choice by shape, counted as the same launch.
// f32 (flash_fwd_kernel, not on a served path): CUDA cores in full f32
//    (never TF32); q, k, v tiles staged in shared memory (transposed q and
//    k, padded against bank conflicts); each thread owns a 4x4 block of
//    scores and a 4 x hd/8 block of the output accumulator.
#include <math.h>

#include <chrono>

#include <cuda.h>   // CUtensorMap and its enums; the encoder is reached through
                    // the runtime (cudaGetDriverEntryPoint): no -lcuda

#include "common.cuh"

namespace {

using namespace repro;

// f32 path
constexpr int BQ = 64;      // query rows per CTA
constexpr int BK = 32;      // keys per kv tile
constexpr int NT = 128;     // threads: 16 row groups x 8 column lanes
constexpr int QS = BQ + 4;  // padded row stride of the transposed q and p tiles
constexpr int KS = BK + 1;  // padded row stride of the transposed k tile
constexpr float NEG = -1e30f;

template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (HD * QS + HD * KS + BK * (HD + 1) + BK * QS);
}

template <int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Skv, int Hq, int Hkv, int causal, int window,
                 float softcap, float scale) {
  constexpr int VS = HD + 1;       // padded row stride of the v tile
  constexpr int NC = HD / 8;       // output columns per thread
  constexpr int V8 = HD / 8;       // 8-element vectors per row
  extern __shared__ float smem[];
  float* qT = smem;                // [HD][QS]
  float* kT = qT + HD * QS;        // [HD][KS]
  float* vS = kT + HD * KS;        // [BK][VS]
  float* pT = vS + BK * VS;        // [BK][QS]

  const int tid = threadIdx.x;
  const int tx = tid & 7;          // column lane
  const int ty = tid >> 3;         // row group: rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  for (int vi = tid; vi < BQ * V8; vi += NT) {
    const int r = vi % BQ, d8 = (vi / BQ) * 8, qi = q0 + r;
    float x[8];
    if (qi < Sq) {
      load8(q + ((size_t)(b * Sq + qi) * Hq + h) * HD + d8, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) qT[(d8 + e) * QS + r] = x[e];
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NC; ++e) acc[i][e] = 0.f;
  }

  int kend = Skv;
  if (causal) kend = min(kend, min(q0 + BQ, Sq));
  int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;
  kbeg = (kbeg / BK) * BK;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();  // previous tile consumed; q tile stored
    for (int vi = tid; vi < BK * V8; vi += NT) {
      const int c = vi % BK, d8 = (vi / BK) * 8, kj = k0 + c;
      float xk[8], xv[8];
      if (kj < Skv) {
        const size_t off = ((size_t)(b * Skv + kj) * Hkv + hk) * HD + d8;
        load8(k + off, xk);
        load8(v + off, xv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) xk[e] = xv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        kT[(d8 + e) * KS + c] = xk[e];
        vS[c * VS + d8 + e] = xv[e];
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&qT[d * QS + ty * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kT[d * KS + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float tmax = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool keep = kj < Skv && (!causal || kj <= qi) &&
                          (window <= 0 || qi - kj < window);
        s[i][j] = keep ? x : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      // the 8 lanes sharing row i are consecutive lanes of one warp
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
      const float mnew = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - mnew);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - mnew);
        pT[(tx + 8 * j) * QS + ty * 4 + i] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = mnew;
#pragma unroll
      for (int e = 0; e < NC; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&pT[c * QS + ty * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int e = 0; e < NC; ++e) {
        const float vv = vS[c * VS + tx + 8 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(pv[i], vv, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + ((size_t)(b * Sq + qi) * Hq + h) * HD;
#pragma unroll
    for (int e = 0; e < NC; ++e) orow[tx + 8 * e] = acc[i][e] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16 at hd 16 and 32: tensor cores through mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int MQ = 64;      // query rows per CTA: 4 warps x 16 rows
constexpr int MK = 64;      // keys per kv tile
constexpr int MT = 128;     // threads

template <int HD>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * ((MQ + MK) * (HD + 8) + HD * (MK + 8));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): with g = lane / 4 and
// t = lane % 4, A registers hold (row g | g+8, cols 2t..2t+1 | +8), B
// registers (k rows 2t..2t+1 | +8, col g), C (row g | g+8, cols 2t..2t+1).
// So the score accumulators of two 8-key blocks are exactly the A operand
// of the p.v product: p never leaves registers.
template <int HD>
__global__ void __launch_bounds__(MT)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int Sq, int Skv, int Hq,
                     int Hkv, int causal, int window, float softcap,
                     float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int RS = HD + 8;   // row stride of the q and k tiles
  constexpr int VS = MK + 8;   // row stride of the transposed v tile
  constexpr int V8 = HD / 8;   // 16-byte chunks per row
  constexpr int KD = HD / 16;  // k-steps of q.k
  constexpr int NB = MK / 8;   // 8-key blocks of a tile
  constexpr int ND = HD / 8;   // 8-column blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [MQ][RS]
  bf16* k_s = q_s + MQ * RS;                      // [MK][RS]
  bf16* vt_s = k_s + MK * RS;                     // [HD][VS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * MQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int vi = tid; vi < MQ * V8; vi += MT) {
    const int r = vi / V8, d8 = (vi % V8) * 8, qi = q0 + r;
    *reinterpret_cast<uint4*>(q_s + r * RS + d8) =
        qi < Sq ? *reinterpret_cast<const uint4*>(
                      q + ((size_t)(b * Sq + qi) * Hq + h) * HD + d8)
                : zero;
  }
  __syncthreads();
  // q fragments stay in registers
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const bf16* p = q_s + (warp * 16 + g) * RS + kk * 16 + 2 * t;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * RS);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * RS + 8);
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  int kend = Skv;
  if (causal) kend = min(kend, min(q0 + MQ, Sq));
  int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;
  kbeg = (kbeg / MK) * MK;

  for (int k0 = kbeg; k0 < kend; k0 += MK) {
    __syncthreads();  // previous tile consumed
    for (int vi = tid; vi < MK * V8; vi += MT) {
      const int c = vi / V8, d8 = (vi % V8) * 8, kj = k0 + c;
      *reinterpret_cast<uint4*>(k_s + c * RS + d8) =
          kj < Skv ? *reinterpret_cast<const uint4*>(
                         k + ((size_t)(b * Skv + kj) * Hkv + hk) * HD + d8)
                   : zero;
    }
    for (int vi = tid; vi < MK * V8; vi += MT) {
      const int c = vi % MK, d8 = (vi / MK) * 8, kj = k0 + c;
      uint4 raw = kj < Skv ? *reinterpret_cast<const uint4*>(
                                 v + ((size_t)(b * Skv + kj) * Hkv + hk) * HD + d8)
                           : zero;
      const bf16* e8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_s[(d8 + e) * VS + c] = e8[e];
    }
    __syncthreads();

    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const bf16* p = k_s + (nb * 8 + g) * RS + kk * 16 + 2 * t;
        const uint32_t bf[2] = {ld32(p), ld32(p + 8)};
        mma_16816(s[nb], qf[kk], bf);
      }
    }

    float tmax[2] = {NEG, NEG};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int kj = k0 + nb * 8 + 2 * t + (e & 1);
        float x = s[nb][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool keep = kj < Skv && (!causal || kj <= row) &&
                          (window <= 0 || row - kj < window);
        s[nb][e] = keep ? x : -INFINITY;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[nb][e]);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the 4 lanes of a quad share a row
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float mnew = fmaxf(m[i], tmax[i]);
      alpha[i] = expf(m[i] - mnew);
      m[i] = mnew;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nb][e];
        const float p = x == -INFINITY ? 0.f : expf(x - m[e >> 1]);
        s[nb][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

#pragma unroll
    for (int kc = 0; kc < MK / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const bf16* p = vt_s + (nd * 8 + g) * VS + kc * 16 + 2 * t;
        const uint32_t bf[2] = {ld32(p), ld32(p + 8)};
        mma_16816(acc[nd], pa, bf);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? row1 : row0;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    bf16* orow = o + ((size_t)(b * Sq + row) * Hq + h) * HD + 2 * t;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8) =
          __floats2bfloat162_rn(acc[nd][2 * i] / denom,
                                acc[nd][2 * i + 1] / denom);
  }
}


// ---------------------------------------------------------------------------
// bf16 at hd 64-256: a TMA-fed ring and warpgroup MMA
// ---------------------------------------------------------------------------

constexpr int TK = 64;         // keys per kv tile
constexpr float LOG2E = 1.4426950408889634f;

// NCW consumer warpgroups of 64 query rows each, then the producer: a
// whole warpgroup when NCW = 2, whose registers setmaxnreg hands to the
// consumers (ptxas gives every thread (24 + 2 * 240) / 3 = 168 at entry, so
// the pool only balances with three warpgroups), and a single warp when
// NCW = 1, which runs without setmaxnreg so that two CTAs fit an SM
template <int HD, int NCW>
struct TmaCfg {
  static constexpr int TQ = 64 * NCW;         // query rows per CTA
  static constexpr int NT = 128 * NCW + (NCW == 2 ? 128 : 32);   // threads
  static constexpr int NSUB = HD / 64;        // 64-column sub-tiles (128 B rows)
  // ring stages: three (two at hd 256); with one warpgroup two CTAs of
  // 112 KB (+ 1 KB static, + 1 KB the runtime keeps) fill the SM's 228 KB
  static constexpr int NST = HD >= 256 ? 2 : 3;
  static constexpr int QSUB = TQ * 128;       // bytes of a q sub-tile
  static constexpr int KSUB = TK * 128;       // bytes of a k or v sub-tile
  static constexpr int QBYTES = NSUB * QSUB;
  static constexpr int KVBYTES = NSUB * KSUB;  // k (or v) tile
  static constexpr int SMEM = QBYTES + NST * 2 * KVBYTES;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// spins until the barrier's phase with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// one 4-d box (64 columns, 1 head, rows, 1 batch row) global -> shared
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (1024-byte
// aligned atoms of 8 rows x 128 B): start address, leading and stride byte
// offsets (>> 4), layout type 1 = SWIZZLE_128B
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching accumulators across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, f32) (+)= A (64 x 16) . B (16 x 64), both from shared memory
// through descriptors (K-major); scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_m64n64(float d[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers: the mma.sync A fragment
// of each warp's 16 rows) . B (16 x 64) from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_m64n64(float d[32],
                                                const uint32_t a[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// byte offset of (row, 16-byte chunk) in a 128-byte-swizzled sub-tile
__device__ __forceinline__ int sw128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// One CTA per (q head, batch row, q tile of TQ rows), q tiles with the most
// kv tiles first.  The last warp is the producer: one thread loads q once
// and then k and v tiles into a ring of NST stages by TMA, each stage with a
// full and an empty mbarrier.  Each consumer warpgroup owns 64 query rows
// (16 per warp): S = Q.K^T by wgmma with both operands from shared memory,
// the online softmax in f32 registers, then O += P.V by wgmma with P from
// registers and V read MN-major through its descriptor.
template <int HD, int NCW>
__global__ void __launch_bounds__(TmaCfg<HD, NCW>::NT, NCW == 1 ? 2 : 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_o, int Sq, int Skv,
                     int Hq, int Hkv, int causal, int window, float softcap,
                     float scale, int nqt) {
  using C = TmaCfg<HD, NCW>;
  constexpr int NSUB = C::NSUB, NST = C::NST, TQ = C::TQ;
  __shared__ __align__(8) uint64_t full_bar[NST], empty_bar[NST], q_bar;
  // 1024-byte aligned (the 128-byte swizzle's atom): the static barriers
  // are padded to 1024 bytes before it
  extern __shared__ __align__(1024) unsigned char tma_smem[];
  unsigned char* q_s = tma_smem;              // [NSUB][TQ rows][128 B]
  unsigned char* kv_s = tma_smem + C::QBYTES; // [NST][k|v][NSUB][TK][128 B]

  const int h = blockIdx.x, b = blockIdx.y, qt = nqt - 1 - (int)blockIdx.z;
  const int q0 = qt * TQ, hk = h / (Hq / Hkv);
  int kend = Skv;
  if (causal) kend = min(kend, min(q0 + TQ, Sq));
  const int kbeg = (window > 0 ? max(0, q0 - window + 1) : 0) / TK * TK;
  const int ntiles = kend > kbeg ? (kend - kbeg + TK - 1) / TK : 0;

  if (threadIdx.x == 0) {
    if (smem_u32(tma_smem) & 1023) __trap();
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 4 * NCW);   // one arrival per consumer warp
    }
    mbar_init(&q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NCW) {
    // ---- producer
    if constexpr (NCW == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 128 * NCW) {
      mbar_expect_tx(&q_bar, C::QBYTES);
#pragma unroll
      for (int s = 0; s < NSUB; ++s)
        tma_load(q_s + s * C::QSUB, &tm_q, &q_bar, s * 64, h, q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % NST;
        mbar_wait(&empty_bar[st], ((it / NST) & 1) ^ 1);
        mbar_expect_tx(&full_bar[st], 2 * C::KVBYTES);
        unsigned char* ks = kv_s + st * 2 * C::KVBYTES;
        unsigned char* vs = ks + C::KVBYTES;
        const int k0 = kbeg + it * TK;
#pragma unroll
        for (int s = 0; s < NSUB; ++s) {
          tma_load(ks + s * C::KSUB, &tm_k, &full_bar[st], s * 64, hk, k0, b);
          tma_load(vs + s * C::KSUB, &tm_v, &full_bar[st], s * 64, hk, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns rows q0 + 64 cw .. + 63
    if constexpr (NCW == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int wrow = 64 * cw + 16 * warp;    // the warp's first row in the tile
    const int row0 = q0 + wrow + g, row1 = row0 + 8;
    const int rmin = q0 + 64 * cw;           // the warpgroup's first row
    // o[s][4j+e]: row (e < 2 ? row0 : row1), column 64 s + 8 j + 2 t + (e & 1)
    float o[NSUB][32];
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[s][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t q_base = smem_u32(q_s) + 64 * cw * 128;

    mbar_wait(&q_bar, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % NST;
      mbar_wait(&full_bar[st], (it / NST) & 1);
      const unsigned char* ks = kv_s + st * 2 * C::KVBYTES;
      const unsigned char* vs = ks + C::KVBYTES;
      const int k0 = kbeg + it * TK;

      // S = Q K^T: s[4j+e] is (row0 | row1, key k0 + 8 j + 2 t + (e & 1))
      float s[32];
      const uint32_t k_base = smem_u32(ks);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns within the atom
        wgmma_ss_m64n64(
            s, sw128_desc(q_base + (kk / 4) * C::QSUB + off, 16, 1024),
            sw128_desc(k_base + (kk / 4) * C::KSUB + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // online softmax in f32 (base 2); only tiles that cross the causal
      // diagonal, the window edge or Skv are masked element-wise
      const bool edge = (causal && k0 + TK - 1 > rmin) ||
                        (window > 0 && rmin + 63 - k0 >= window) ||
                        k0 + TK > Skv;
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          x *= LOG2E;
          if (edge) {
            const int row = e < 2 ? row0 : row1;
            const int kj = k0 + 8 * j + 2 * t + (e & 1);
            const bool keep = kj < Skv && (!causal || kj <= row) &&
                              (window <= 0 || row - kj < window);
            x = keep ? x : -INFINITY;
          }
          s[4 * j + e] = x;
          tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
        }
      }
      float alpha[2], msafe[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
        const float mnew = fmaxf(m[i], tmax[i]);
        msafe[i] = mnew == -INFINITY ? 0.f : mnew;
        alpha[i] = exp2f(m[i] - msafe[i]);
        m[i] = mnew;
      }
      uint32_t pa[4][4];   // P as the A operand of P.V, k-step kc = keys 16 kc..
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2f(s[4 * j + 0] - msafe[0]);
        const float p1 = exp2f(s[4 * j + 1] - msafe[0]);
        const float p2 = exp2f(s[4 * j + 2] - msafe[1]);
        const float p3 = exp2f(s[4 * j + 3] - msafe[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pa[j / 2][2 * (j & 1)] = pack_bf16(p0, p1);
        pa[j / 2][2 * (j & 1) + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] = l[i] * alpha[i] + rs[i];
      }
#pragma unroll
      for (int sN = 0; sN < NSUB; ++sN)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[sN][4 * j + 0] *= alpha[0];
          o[sN][4 * j + 1] *= alpha[0];
          o[sN][4 * j + 2] *= alpha[1];
          o[sN][4 * j + 3] *= alpha[1];
        }

      // O += P V (V's descriptor: 8-row groups 1024 B apart; one 64-column
      // atom per instruction)
      const uint32_t v_base = smem_u32(vs);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < TK / 16; ++kc)
#pragma unroll
        for (int sN = 0; sN < NSUB; ++sN)
          wgmma_rs_m64n64(o[sN], pa[kc],
                          sw128_desc(v_base + sN * C::KSUB + kc * 2048, 1024,
                                     1024));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int sN = 0; sN < NSUB; ++sN) fence_regs(o[sN]);
      // the warp's products are done (wgmma.wait_group): its lane 0 frees
      // the stage for the warp
      if (lane == 0) mbar_arrive(&empty_bar[st]);
    }

    // epilogue: normalise, stage the warpgroup's 64 x HD tile in its own
    // (consumed) q rows in the swizzled layout, one thread stores it by TMA
    // (rows past Sq are clipped)
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int sN = 0; sN < NSUB; ++sN)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wrow + g + 8 * i;
          *reinterpret_cast<uint32_t*>(q_s + sN * C::QSUB + sw128(r, j) +
                                       4 * t) =
              pack_bf16(o[sN][4 * j + 2 * i] * inv[i],
                        o[sN][4 * j + 2 * i + 1] * inv[i]);
        }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    if (tid == 0) {
#pragma unroll
      for (int sN = 0; sN < NSUB; ++sN)
        tma_store(&tm_o, q_s + sN * C::QSUB + 64 * cw * 128, sN * 64, h,
                  q0 + 64 * cw, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                       int window, float softcap, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<HD>();
  auto kern = flash_fwd_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + MQ - 1) / MQ, Hq, B);
  kern<<<grid, MT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq,
      Skv, Hq, Hkv, causal, window, softcap, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}


typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once
cudaError_t encode_fn(EncodeTiledFn* out) {
  static EncodeTiledFn fn = nullptr;
  static const cudaError_t status = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &res);
#endif
    if (e != cudaSuccess) return e;
    if (res != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiledFn>(p);
    return cudaSuccess;
  }();
  *out = fn;
  return status;
}

// (B, S, H, hd) bf16 as a 4-d tensor map (innermost first) whose box is 64
// columns x 1 head x rows x 1 batch row, 128-byte swizzled; rows past S
// load as zeros and are clipped on store.  Built on every call (the
// encoder is host arithmetic: chip_smoke.py times it through
// flash_attention_tensor_map_ns), so no cache can go stale.
cudaError_t tensor_map(EncodeTiledFn enc, CUtensorMap* map, const void* p,
                       int hd, int H, int S, int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2,
                                 (cuuint64_t)S * H * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(p), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD, int NCW>
cudaError_t launch_tma(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                       int window, float softcap, cudaStream_t stream) {
  using C = TmaCfg<HD, NCW>;
  const int nqt = (Sq + C::TQ - 1) / C::TQ;
  if (nqt > 65535 || B > 65535) return cudaErrorInvalidValue;
  EncodeTiledFn enc;
  cudaError_t err = encode_fn(&enc);
  CUtensorMap mq, mk, mv, mo;
  if (err == cudaSuccess) err = tensor_map(enc, &mq, q, HD, Hq, Sq, B, C::TQ);
  if (err == cudaSuccess) err = tensor_map(enc, &mk, k, HD, Hkv, Skv, B, TK);
  if (err == cudaSuccess) err = tensor_map(enc, &mv, v, HD, Hkv, Skv, B, TK);
  if (err == cudaSuccess) err = tensor_map(enc, &mo, o, HD, Hq, Sq, B, 64);
  auto kern = flash_fwd_tma_kernel<HD, NCW>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Hq, B, nqt), C::NT, C::SMEM, stream>>>(
      mq, mk, mv, mo, Sq, Skv, Hq, Hkv, causal, window, softcap,
      1.0f / sqrtf((float)HD), nqt);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                       int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, Hq, Hkv,
      causal, window, softcap, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 = launched).  Does not synchronize.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int Sq, int Skv,
                                   int Hq, int Hkv, int hd, int causal,
                                   int window, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    switch (hd) {
      // hd 16 and 32: rows under 128 B do not take the 128-byte swizzle this
      // design is built on, so these (smoke-size) shapes stay on mma.sync
      case 16: return (int)launch_mma<16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, s);
      case 32: return (int)launch_mma<32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, s);
      case 64: return (int)launch_tma<64, 1>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, s);
      case 128: return (int)launch_tma<128, 1>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, s);
      case 256: return (int)launch_tma<256, 2>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == kF32) {
    switch (hd) {
      case 16: return (int)launch_f32<16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, s);
      case 32: return (int)launch_f32<32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, s);
      case 64: return (int)launch_f32<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, s);
      case 128: return (int)launch_f32<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, s);
      case 256: return (int)launch_f32<256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Mean host time in ns of encoding the four tensor maps of one call (q, k,
// v, o at yi-9b's prefill shape, all on the device buffer buf), over reps
// calls; negative on an error.
extern "C" int flash_attention_tensor_map_ns(const void* buf, int reps) {
  EncodeTiledFn enc;
  if (encode_fn(&enc) != cudaSuccess || reps <= 0) return -1;
  CUtensorMap m[4];
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    if (tensor_map(enc, &m[0], buf, 128, 32, 512, 8, 64) != cudaSuccess ||
        tensor_map(enc, &m[1], buf, 128, 4, 512, 8, TK) != cudaSuccess ||
        tensor_map(enc, &m[2], buf, 128, 4, 512, 8, TK) != cudaSuccess ||
        tensor_map(enc, &m[3], buf, 128, 32, 512, 8, 64) != cudaSuccess)
      return -2;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return (int)(std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0)
                   .count() / reps);
}
