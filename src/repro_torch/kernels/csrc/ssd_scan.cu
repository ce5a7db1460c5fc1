// K3: the Mamba2 SSD chunked scan, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel / ssd_scan_fwd).  Same function: x (B,S,H,P), dt (B,S,H)
// f32, A (H,) f32, one group of B/C (B,S,N); per (batch, head) and per
// chunk of `chunk` rows, with cs the running sum of dt*A inside the chunk,
//   y_i    = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//            + exp(cs_i) C_i . state                      (state: P x N)
//   state <- state exp(cs_last) + sum_j exp(cs_last - cs_j) dt_j x_j B_j^T
// y in x's dtype, the final state in f32.  All math in f32 on the CUDA
// cores (the TPU kernel casts to f32 before its dots; no TF32 here).
//
// What bounds it on the H100: operations.  At the serving path's shape
// (B=8, S=1024, H=64, P=64, N=128, chunk 256, bf16) the chunked algorithm
// needs about 2.6e10 FLOP (causal pairs only, C.B^T once per batch row and
// chunk), 0.39 ms at 67 TFLOP/s f32, and moves x, y, dt, B, C and the state
// (about 157 MB, 47 us at 3.35 TB/s).
//
// Design (simple and correct first):
//  * one CTA per (head, batch), 256 threads.  The TPU's sequential chunk
//    grid axis becomes a loop over chunks inside the CTA; the (P, N) f32
//    state stays in shared memory from one chunk to the next.
//  * the chunk is walked in row blocks of 64: for row block I,
//    y_I = exp(cs_I) C_I state^T + sum_{J<=I} (C_I B_J^T o L_IJ)(x dt)_J, a
//    causal "attention without softmax"; the decay exp(cs_i - cs_j) is
//    taken only where i >= j (for i < j it would overflow).  Then the state
//    update walks the chunk's row blocks once more.
//  * each thread owns a 4x4 tile of every 64x64 product (16x16 threads),
//    reading float4 rows of transposed, padded shared-memory tiles.
//  * ragged sequences: rows past S load as zeros (dt = 0: decay 1,
//    contribution 0), so the last chunk needs no padded copy and the final
//    state is exact.  No S % chunk requirement.
//  * first lever for the redesign: C_I B_J^T is the same for all H heads
//    of a batch row (one group), yet each head's CTA recomputes it, about
//    half of this kernel's products.  Sharing it across heads and running
//    the products on tensor cores (mma / wgmma) come later.
#include <math.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int NT = 256;      // threads: 16 x 16, each owning a 4x4 tile
constexpr int BR = 64;       // rows of a chunk's row block
constexpr int CMAX = 256;    // longest chunk (one thread per row in the scan)
constexpr int PMAX = 64;     // largest head dim
constexpr int NMAX = 128;    // largest state size
constexpr int LD = BR + 4;   // row stride of the [n][row] and [row][p] tiles
constexpr int LDN = NMAX + 4;  // row stride of the natural [row][n] B tile
constexpr size_t SMEM_FLOATS =
    3 * NMAX * LD + 2 * BR * LD + 2 * CMAX + 32;
static_assert(NT == CMAX, "the chunk scan gives each thread one row");
static_assert(PMAX == 4 * 16 && BR == 4 * 16, "4x4 tiles of 16x16 threads");
static_assert(BR * LDN <= NMAX * LD, "natural B tile fits the B buffer");

__device__ __forceinline__ void fma44(float acc[4][4], const float4 a,
                                      const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// inclusive prefix sum over the CTA's 256 threads
__device__ float block_scan(float v, float* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += wsum[w];
  return v;
}

// dst[n * LD + r] = src[(row + r) * N + n] (rows r >= nrows: zero)
template <typename T>
__device__ void load_rows_t(float* dst, const T* __restrict__ src,
                            size_t row, int nrows, int N) {
  for (int i = threadIdx.x; i < BR * N; i += NT) {
    const int r = i / N, n = i - r * N;
    dst[n * LD + r] = r < nrows ? to_f(src[(row + r) * N + n]) : 0.f;
  }
}

// dst[r * LDN + n] = src[(row + r) * N + n] (zero past nrows or N)
template <typename T>
__device__ void load_rows_n(float* dst, const T* __restrict__ src,
                            size_t row, int nrows, int N) {
  for (int i = threadIdx.x; i < BR * NMAX; i += NT) {
    const int r = i / NMAX, n = i % NMAX;
    dst[r * LDN + n] =
        r < nrows && n < N ? to_f(src[(row + r) * N + n]) : 0.f;
  }
}

// dst[r * LD + p] = x[row + r, h, p] * dt_r (* exp(last - cs_r) if decay)
template <typename T>
__device__ void load_xdt(float* dst, const T* __restrict__ x, size_t row,
                         int nrows, int H, int h, int P, const float* dts,
                         const float* cs, float last, bool decay) {
  for (int i = threadIdx.x; i < BR * PMAX; i += NT) {
    const int r = i / PMAX, p = i % PMAX;
    float v = 0.f;
    if (r < nrows && p < P) {
      v = to_f(x[((row + r) * H + h) * P + p]) * dts[r];
      if (decay) v *= expf(last - cs[r]);
    }
    dst[r * LD + p] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int N,
                int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* stT = smem;               // [NMAX][LD]  state^T: stT[n][p]
  float* CT = stT + NMAX * LD;     // [NMAX][LD]  C of row block I: CT[n][i]
  float* BT = CT + NMAX * LD;      // [NMAX][LD]  B of row block J: BT[n][j]
                                   //   (state update: [BR][LDN], B[j][n])
  float* XS = BT + NMAX * LD;      // [BR][LD]    (x dt)_J: XS[j][p]
  float* SS = XS + BR * LD;        // [BR][LD]    masked scores^T: SS[j][i]
  float* cs = SS + BR * LD;        // [CMAX]      running sum of dt A
  float* dts = cs + CMAX;          // [CMAX]      dt
  float* wsum = dts + CMAX;        // [32]        scan scratch

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.x, b = blockIdx.y;
  const float Ah = A[h];
  const size_t brow = (size_t)b * S;   // first (b, s) row of this batch

  for (int i = tid; i < NMAX * LD; i += NT) stT[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int len = min(chunk, S - c0);
    const size_t crow = brow + c0;
    __syncthreads();   // the previous chunk is done with cs, dts, wsum, stT
    const float d = tid < len ? dt[(crow + tid) * H + h] : 0.f;
    const float v = block_scan(d * Ah, wsum);
    cs[tid] = v;       // rows past len add 0: cs[CMAX-1] is the chunk's last
    dts[tid] = d;
    __syncthreads();
    const float last = cs[CMAX - 1];

    for (int i0 = 0; i0 < len; i0 += BR) {
      load_rows_t(CT, Cm, crow + i0, len - i0, N);
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      // y_off = exp(cs_i) C_i . state
#pragma unroll 4
      for (int n = 0; n < N; ++n)
        fma44(acc, ld4(CT + n * LD + ty * 4), ld4(stT + n * LD + tx * 4));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = expf(cs[i0 + ty * 4 + r]);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= e;
      }
      for (int j0 = 0; j0 <= i0; j0 += BR) {
        __syncthreads();   // BT, XS and SS are free
        load_rows_t(BT, Bm, crow + j0, len - j0, N);
        load_xdt(XS, x, crow + j0, len - j0, H, h, P, dts + j0, cs + j0,
                 last, false);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n)
          fma44(s, ld4(CT + n * LD + ty * 4), ld4(BT + n * LD + tx * 4));
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + tx * 4 + c;
          float col[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + ty * 4 + r;
            col[r] = i >= j ? s[r][c] * expf(cs[i] - cs[j]) : 0.f;
          }
          *reinterpret_cast<float4*>(SS + (tx * 4 + c) * LD + ty * 4) =
              make_float4(col[0], col[1], col[2], col[3]);
        }
        __syncthreads();
        const int jn = min(BR, len - j0);
        for (int j = 0; j < jn; ++j)
          fma44(acc, ld4(SS + j * LD + ty * 4), ld4(XS + j * LD + tx * 4));
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i >= len) continue;
        T* yrow = y + ((crow + i) * H + h) * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx * 4 + c;
          if (p < P) yrow[p] = from_f<T>(acc[r][c]);
        }
      }
      __syncthreads();   // CT is free
    }

    // state update: thread owns p = ty*4 + r, n = tx*4 + c and 64 + tx*4 + c
    float sacc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) sacc[r][c] = 0.f;
    for (int j0 = 0; j0 < len; j0 += BR) {
      __syncthreads();
      load_rows_n(BT, Bm, crow + j0, len - j0, N);
      load_xdt(XS, x, crow + j0, len - j0, H, h, P, dts + j0, cs + j0, last,
               true);
      __syncthreads();
      const int jn = min(BR, len - j0);
      for (int j = 0; j < jn; ++j) {
        const float4 xv = ld4(XS + j * LD + ty * 4);
        const float4 b0 = ld4(BT + j * LDN + tx * 4);
        const float4 b1 = ld4(BT + j * LDN + 64 + tx * 4);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
        const float bc[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            sacc[r][c] = fmaf(xr[r], bc[c], sacc[r][c]);
      }
    }
    __syncthreads();
    const float el = expf(last);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int p = ty * 4 + r, n = (c < 4 ? 0 : 64) + tx * 4 + (c & 3);
        stT[n * LD + p] = stT[n * LD + p] * el + sacc[r][c];
      }
  }

  __syncthreads();
  float* out = state_out + ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += NT) {
    const int p = i / N, n = i - p * N;
    out[i] = stT[n * LD + p];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* state,
                   int B, int S, int H, int P, int N, int chunk,
                   cudaStream_t stream) {
  const size_t smem = SMEM_FLOATS * sizeof(float);
  auto kern = ssd_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), S, H, P, N, chunk);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 = launched).  Does not synchronize.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            void* state, int dtype, int B, int S, int H,
                            int P, int N, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || P <= 0 || P > PMAX ||
      P % 4 || N <= 0 || N > NMAX || N % 4 || chunk <= 0 || chunk > CMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return (int)launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, S, H,
                                      P, N, chunk, s);
  if (dtype == kF32)
    return (int)launch<float>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N,
                              chunk, s);
  return (int)cudaErrorInvalidValue;
}
