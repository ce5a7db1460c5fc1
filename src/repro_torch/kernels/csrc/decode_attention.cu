// K1: single-token decode attention over a ring KV cache, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_decode_kernel / decode_attention_fwd).  Same function: q (B,1,Hq,hd)
// against k/v (B,cap,Hkv,hd) with absolute slot positions kv_pos (cap,);
// a slot takes part when kv_pos <= pos and (window == 0 or
// pos - kv_pos < window).  Unwritten slots hold 2^30 and so never take
// part: the ring layout relies on masking by kv_pos, not by length.
// Scores scaled by hd^-0.5, optional tanh softcap, online softmax in f32,
// output in q's dtype.  Any cap is taken (no cap % block requirement).
//
// What bounds it on the H100: bytes.  At the serving path's shape (B=8,
// cap=640, Hkv=4, hd=128, bf16) a call reads up to 2*8*640*4*128*2 B =
// 10.5 MB of k/v, 3.1 us at 3.35 TB/s; it does 4*B*Hq*hd FLOP per valid
// slot (84 MFLOP at cap 640), far below the compute bound.
//
// Design (simple and correct first):
//  * one CTA per (kv head, batch) covers the G = Hq/Hkv query heads of that
//    kv head together, like the TPU tile, so each k/v row is read once for
//    all G heads.  256 threads; the cache is walked in blocks of 128 slots
//    (64 for rows over 512 bytes).
//  * each block's kept k and v rows are staged in shared memory with
//    coalesced 16-byte loads (consecutive threads, consecutive bytes; all
//    loads of a block in flight together); masked slots are never read.
//  * scores: a thread per (slot, head group) dots the staged k row with the
//    query rows held in shared memory (broadcast reads).
//  * softmax statistics: one warp per query head reduces the block's scores
//    with shuffles and rescales the running max/sum.
//  * p.v: threads own output columns (and, for hd < 256, a subset of the
//    block's slots, reduced at the end), reading the staged v rows.
//  * products run on the CUDA cores in f32 (full f32 for f32 inputs).
//  * the position is read from device memory, so a decode step needs no
//    host round trip.
#include <math.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int NT = 256;    // threads per CTA
constexpr int GMAX = 16;   // most query heads per kv head
constexpr float NEG = -1e30f;

// cache slots per block: as many as keep the k and v tiles near 130 KB
template <typename T, int HD>
__host__ __device__ constexpr int block_slots() { return HD * (int)sizeof(T) > 512 ? 64 : 128; }
// row stride of the shared k/v tiles: 16 bytes of padding against bank
// conflicts, keeping rows 16-byte aligned
template <typename T, int HD>
__host__ __device__ constexpr int row_stride() { return HD + 16 / (int)sizeof(T); }
template <typename T, int HD>
__host__ __device__ constexpr size_t tile_bytes() {
  return 2 * sizeof(T) * block_slots<T, HD>() * row_stride<T, HD>();
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
decode_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ kv_pos,
                  const int* __restrict__ pos_ptr, T* __restrict__ o, int cap,
                  int Hq, int Hkv, int window, float softcap, float scale) {
  constexpr int BK = block_slots<T, HD>();
  constexpr int KS = row_stride<T, HD>();
  constexpr int SG = NT / BK;                   // head groups in the scores
  constexpr int R = HD >= NT ? 1 : NT / HD;     // slot subsets in p.v
  constexpr int COLS = HD >= NT ? HD / NT : 1;  // columns per thread in p.v
  constexpr int V8 = HD / 8;
  __shared__ float q_s[GMAX][HD];
  __shared__ float s_s[GMAX][BK];
  __shared__ float red[R > 1 ? GMAX : 1][NT];
  __shared__ int keep_s[BK];
  __shared__ float m_s[GMAX], l_s[GMAX], a_s[GMAX];
  extern __shared__ __align__(16) unsigned char tiles[];
  T* k_s = reinterpret_cast<T*>(tiles);         // [BK][KS]
  T* v_s = k_s + BK * KS;                       // [BK][KS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int pos = *pos_ptr;
  const int sc = tid % BK, sg = tid / BK;       // score slot / head group
  const int d0 = tid % (NT / R);                // first p.v column
  const int r0 = tid / (NT / R);                // p.v slot subset

  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    q_s[g][d] = to_f(q[((size_t)b * Hq + hk * G + g) * HD + d]);
  }
  if (tid < GMAX) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  float acc[GMAX][COLS];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[g][c] = 0.f;

  for (int t0 = 0; t0 < cap; t0 += BK) {
    __syncthreads();  // previous block consumed; q and stats initialised
    if (tid < BK) {
      const int j = t0 + tid;
      bool keep = false;
      if (j < cap) {
        const int kp = kv_pos[j];
        keep = kp <= pos && (window <= 0 || pos - kp < window);
      }
      keep_s[tid] = keep;
    }
    __syncthreads();
    // stage the kept k and v rows: consecutive threads, consecutive 16 B
    for (int vi = tid; vi < BK * V8; vi += NT) {
      const int c = vi / V8, d8 = (vi % V8) * 8;
      if (keep_s[c]) {
        const size_t off = ((size_t)(b * cap + t0 + c) * Hkv + hk) * HD + d8;
        *reinterpret_cast<uint4*>(k_s + c * KS + d8) =
            *reinterpret_cast<const uint4*>(k + off);
        *reinterpret_cast<uint4*>(v_s + c * KS + d8) =
            *reinterpret_cast<const uint4*>(v + off);
        if (sizeof(T) == 4) {  // 8 f32 = two 16-byte chunks
          *reinterpret_cast<uint4*>(k_s + c * KS + d8 + 4) =
              *reinterpret_cast<const uint4*>(k + off + 4);
          *reinterpret_cast<uint4*>(v_s + c * KS + d8 + 4) =
              *reinterpret_cast<const uint4*>(v + off + 4);
        }
      }
    }
    __syncthreads();

    // scores: thread (slot sc, head group sg) covers heads sg, sg+SG, ...
    const bool keep = keep_s[sc];
    float s[GMAX / SG];
#pragma unroll
    for (int i = 0; i < GMAX / SG; ++i) s[i] = 0.f;
    if (keep) {
      for (int d = 0; d < HD; d += 8) {
        float x[8];
        load8(k_s + sc * KS + d, x);
#pragma unroll
        for (int i = 0; i < GMAX / SG; ++i) {
          const int g = sg + i * SG;
          if (g < G) {
#pragma unroll
            for (int e = 0; e < 8; ++e) s[i] = fmaf(q_s[g][d + e], x[e], s[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < GMAX / SG; ++i) {
      const int g = sg + i * SG;
      if (g < G) {
        float x = s[i] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s_s[g][sc] = keep ? x : -INFINITY;
      }
    }
    __syncthreads();

    // softmax statistics: one warp per head
    for (int g = warp; g < G; g += NT / 32) {
      float x[BK / 32];
      float tmax = NEG;
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        x[i] = s_s[g][lane + 32 * i];
        tmax = fmaxf(tmax, x[i]);
      }
      tmax = warp_max(tmax);
      const float mold = m_s[g];
      const float mnew = fmaxf(mold, tmax);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        const float p = x[i] == -INFINITY ? 0.f : expf(x[i] - mnew);
        s_s[g][lane + 32 * i] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(mold - mnew);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = mnew;
      }
    }
    __syncthreads();

    // p.v from the staged v rows
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[g][c] *= a_s[g];
      }
    }
    const int nb = min(BK, cap - t0);
#pragma unroll 4
    for (int jj = r0; jj < nb; jj += R) {
      if (!keep_s[jj]) continue;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const float vv = to_f(v_s[jj * KS + d0 + c * NT]);
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) acc[g][c] = fmaf(s_s[g][jj], vv, acc[g][c]);
      }
    }
  }

  T* orow = o + ((size_t)b * Hq + hk * G) * HD;
  if (R > 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) red[g][tid] = acc[g][0];
    __syncthreads();
    for (int i = tid; i < G * HD; i += NT) {
      const int g = i / HD, d = i % HD;
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) sum += red[g][r * HD + d];
      orow[g * HD + d] = from_f<T>(sum / fmaxf(l_s[g], 1e-30f));
    }
  } else {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          orow[g * HD + d0 + c * NT] =
              from_f<T>(acc[g][c] / fmaxf(l_s[g], 1e-30f));
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_pos, const int* pos, void* o, int B, int cap,
                   int Hq, int Hkv, int window, float softcap,
                   cudaStream_t stream) {
  const size_t smem = tile_bytes<T, HD>();
  auto kern = decode_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_pos, pos, static_cast<T*>(o), cap, Hq, Hkv,
      window, softcap, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* kv_pos, const int* pos, void* o, int B,
                        int cap, int Hq, int Hkv, int window, float softcap,
                        cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, kv_pos, pos, o, B, cap, Hq, Hkv, window, softcap, s);
    case 32: return launch<T, 32>(q, k, v, kv_pos, pos, o, B, cap, Hq, Hkv, window, softcap, s);
    case 64: return launch<T, 64>(q, k, v, kv_pos, pos, o, B, cap, Hq, Hkv, window, softcap, s);
    case 128: return launch<T, 128>(q, k, v, kv_pos, pos, o, B, cap, Hq, Hkv, window, softcap, s);
    case 256: return launch<T, 256>(q, k, v, kv_pos, pos, o, B, cap, Hq, Hkv, window, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t code (0 = launched).  Does not synchronize.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* kv_pos,
                                    const void* pos, void* o, int dtype, int B,
                                    int cap, int Hq, int Hkv, int hd,
                                    int window, float softcap, void* stream) {
  if (B <= 0 || cap <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > GMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kp = static_cast<const int*>(kv_pos);
  const int* p = static_cast<const int*>(pos);
  if (dtype == kBF16)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, kp, p, o, B, cap, Hq,
                                           Hkv, window, softcap, s);
  if (dtype == kF32)
    return (int)dispatch_hd<float>(hd, q, k, v, kp, p, o, B, cap, Hq, Hkv,
                                   window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
