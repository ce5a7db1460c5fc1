// K2: flash-attention forward (prefill), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention_fwd).  Same function: q (B,Sq,Hq,hd),
// k/v (B,Skv,Hkv,hd), query head h reads kv head h / (Hq/Hkv); scores scaled
// by hd^-0.5, optional tanh softcap, causal and sliding-window masks over
// positions contiguous from 0; online softmax in f32; output in q's dtype.
//
// What bounds it on the H100: at the serving path's shape (B=8, S=512,
// Hq=32, Hkv=4, hd=128, causal, bf16) one call does
// 4 * hd * B * Hq * S(S+1)/2 = 1.72e10 FLOP, 17.4 us at 989 TFLOP/s, and
// must move q and o (33.5 MB each) plus k and v (4.2 MB each), 75.5 MB or
// 22.5 us at 3.35 TB/s: bytes, narrowly.  The operations bound binds once
// the prompt is longer or the group wider.
//
// Design (simple and correct first; wgmma/TMA come later).  Both paths:
//  * one CTA per (q-tile of 64 rows, q head, batch); 128 threads.  The
//    TPU's sequential kv grid axis becomes a loop over kv tiles inside the
//    CTA, stopping at the causal edge and starting at the window edge, so
//    fully masked tiles are never loaded.
//  * online softmax in f32 registers; row max/sum across the lanes that
//    share a row with warp shuffles; masked scores contribute exactly 0.
//  * ragged edges (Sq or Skv not a multiple of the tile) are masked here;
//    there is no Sq % bq requirement.
//  * head dims 16-256.  At hd 256 (recurrentgemma-9b) the bf16 tile takes
//    2 * ((64 + 64) * 264 + 256 * 72) B = 104 KB of shared memory and the
//    f32 path 145 KB; the bf16 path then reads its q fragments from shared
//    memory at each k-step, so the 128 output accumulators keep their
//    registers.
// bf16 (the serving path): tensor cores through mma.sync m16n8k16, bf16
//    in, f32 accumulate.  Each warp owns 16 query rows; q fragments stay in
//    registers, k and a transposed v tile of 64 keys are staged in shared
//    memory with 16-byte loads.  The score accumulators are reused as the
//    A operand of p.v (p rounded to bf16, as the TPU kernel does), so p
//    never touches shared memory.
// f32: CUDA cores in full f32 (never TF32).  q, k, v tiles are staged in
//    shared memory as f32 (transposed q and k, padded against bank
//    conflicts); each thread owns a 4x4 block of scores and a 4 x hd/8
//    block of the output accumulator.
#include <math.h>

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
// bf16 path: tensor cores through mma.sync m16n8k16 (bf16 in, f32 out)
// ---------------------------------------------------------------------------

constexpr int MQ = 64;      // query rows per CTA: 4 warps x 16 rows
constexpr int MK = 64;      // keys per kv tile
constexpr int MT = 128;     // threads

template <int HD>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * ((MQ + MK) * (HD + 8) + HD * (MK + 8));
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
  // q fragments: in registers up to hd 128; at hd 256 they would take 64
  // registers beside the 128 of the output accumulator, so they are read
  // from the (resident) q tile at each k-step instead.
  constexpr bool QREG = HD <= 128;
  uint32_t qf[QREG ? KD : 1][4];
  auto q_frag = [&](int kk, uint32_t a[4]) {
    const bf16* p = q_s + (warp * 16 + g) * RS + kk * 16 + 2 * t;
    a[0] = ld32(p);
    a[1] = ld32(p + 8 * RS);
    a[2] = ld32(p + 8);
    a[3] = ld32(p + 8 * RS + 8);
  };
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) q_frag(kk, qf[kk]);
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
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        q_frag(kk, qa);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const bf16* p = k_s + (nb * 8 + g) * RS + kk * 16 + 2 * t;
        const uint32_t bf[2] = {ld32(p), ld32(p + 8)};
        mma_16816(s[nb], qa, bf);
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
      case 16: return (int)launch_mma<16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, s);
      case 32: return (int)launch_mma<32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, s);
      case 64: return (int)launch_mma<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, s);
      case 128: return (int)launch_mma<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, s);
      case 256: return (int)launch_mma<256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, softcap, s);
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
