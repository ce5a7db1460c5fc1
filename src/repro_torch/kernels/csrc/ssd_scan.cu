// K3: the Mamba2 SSD chunked scan, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel / ssd_scan_fwd).  Same function: x (B,S,H,P), dt (B,S,H)
// f32, A (H,) f32, one group of B/C (B,S,N); per (batch, head) and per
// chunk of `chunk` rows, with cs the running sum of dt*A inside the chunk,
//   y_i    = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//            + exp(cs_i) C_i . state                      (state: P x N)
//   state <- state exp(cs_last) + sum_j exp(cs_last - cs_j) dt_j x_j B_j^T
// y in x's dtype, the final state in f32.
//
// Two routes, chosen by the wrapper (ops.py: route) and passed in:
//  * ROUTE_MMA, bf16 with P and N multiples of 16 (the served dtype):
//    ssd_scan_mma_kernel runs the four products on tensor cores
//    (mma.sync m16n8k16, f32 accumulate).  Every product has one operand
//    that is exact bf16 in memory (C, B or x); the other, f32, operand
//    (the gated scores, the state, the weighted x) is split into
//    hi = bf16(v) and lo = bf16(v - hi), two mma per product, which
//    carries it to about 2^-16: y and the state match f32 arithmetic
//    (rounding the f32 operand once would put the state 1e-2 off).
//  * ROUTE_CUDA_CORE, f32 (and bf16 at other shapes): ssd_scan_kernel, all
//    math in f32 on the CUDA cores (the TPU kernel casts to f32 before its
//    dots; no TF32 here).
//
// What bounds it on the H100, at the serving path's shape (B=8, S=1024,
// H=64, P=64, N=128, chunk 256, bf16): the chunked algorithm needs about
// 2.6e10 FLOP (causal pairs only, C.B^T once per batch row and chunk) and
// moves x, y, dt, B, C and the state (about 157 MB).  In f32 on the CUDA
// cores that is operations (0.39 ms at 67 TFLOP/s); on the tensor cores
// bytes (47 us at 3.35 TB/s; 26 us at 989 TFLOP/s).  The mma route does
// about 8e10 FLOP of mma: each head's CTA recomputes C.B^T (a quarter of
// its products) and the split doubles three of the four products.
//
// Shared design: one CTA per (head, batch); the TPU's sequential chunk
// grid axis becomes a loop over chunks inside the CTA, the (P, N) f32 state
// carried from one chunk to the next.  The chunk is walked in row blocks of
// 64: for row block I, y_I = exp(cs_I) C_I state^T + sum_{J<=I}
// (C_I B_J^T o L_IJ)(x dt)_J, a causal "attention without softmax"; the
// decay exp(cs_i - cs_j) is taken only where i >= j (for i < j it would
// overflow).  Rows past S or past the chunk load as zeros with dt = 0
// (decay 1, contribution 0), so the last chunk needs no padded copy and the
// final state is exact: no S % chunk or chunk % 64 requirement.  Fixed
// order, no atomics: two calls give the same bits.
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace repro;

enum Route : int { ROUTE_CUDA_CORE = 0, ROUTE_MMA = 1 };  // ops.py: ROUTES

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

// ---------------------------------------------------------------------------
// ROUTE_CUDA_CORE: f32 math on the CUDA cores.  256 threads; each owns a 4x4
// tile of every 64x64 product (16x16 threads), reading float4 rows of
// transposed, padded shared-memory tiles; the (P, N) f32 state stays in
// shared memory; the state update walks the chunk's row blocks once more.
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// ROUTE_MMA: bf16 on tensor cores, the f32 operand of each product split
// ---------------------------------------------------------------------------
//
// 4 warps; warp w owns rows 16w..16w+15 of the 64-row block I (y) and rows
// p = 16w..16w+15 of the state.  Per chunk, row block I and column block
// J <= I (m16n8k16 fragments; C, B, x exact bf16):
//   y_off  acc  = exp(cs_i) (C_I . St^T)        St = state at chunk entry,
//                                               split once a chunk into a
//                                               bf16 hi/lo [p][n] tile
//   S_IJ        = C_I . B_J^T                   C_I fragments in registers
//   M_ij        = S_ij exp(cs_i - cs_j) dt_j    i >= j only, on the
//                                               accumulators (as K2's P)
//   y_I   acc  += M_IJ . X_J                    M split hi/lo
//   state       = state exp(cs_last) + sum_J (w o X_J)^T . B_J,
//                 w_j = exp(cs_last - cs_j) dt_j, split hi/lo; run in the
//                 last row block's pass over J, which loads every B_J, X_J.
// dt goes into M and w, never into x, so x stays exact.  The f32 state
// lives in registers (the state product's accumulators); y_off reads the
// split copy, so the update cannot disturb what y_off of the same chunk
// still reads.  On the diagonal block a warp skips the column blocks past
// its last row.  B_J and X_J stream through a 2-stage cp.async ring
// (zero-fill past the chunk), C_I through one buffer that is free once
// the warps hold its fragments; MMA_SMEM_BYTES = 109,696 B (about 107 KiB)
// of shared memory, two CTAs per SM.

constexpr int MT = 128;             // threads: 4 warps x 16 rows
constexpr int LDH = NMAX + 8;       // bf16 row stride of the C, B, state tiles
constexpr int LDX = PMAX + 8;       // bf16 row stride of the x tiles
constexpr size_t MMA_SMEM_BYTES =
    sizeof(__nv_bfloat16) * (3 * BR * LDH + 2 * PMAX * LDH + 2 * BR * LDX) +
    sizeof(float) * (4 * CMAX + 32);
static_assert(MT * 2 == CMAX, "the chunk scan gives each thread two rows");
static_assert(PMAX == 4 * 16 && BR == 4 * 16, "4 warps of 16 rows");
static_assert(MMA_SMEM_BYTES <= 113 * 1024, "two CTAs per SM");

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 bf2_floats(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// (a, b) = hi + lo to about 2^-16 of each: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf2_bits(h);
  lo = bf2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// rows [0, 64) of a bf16 matrix with row stride `stride` (elements), `cols`
// elements each (a multiple of 8), into a [64][ld] tile; rows >= nrows are
// zero-filled (no global read)
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          size_t stride, int nrows,
                                          int cols) {
  const int c8 = cols >> 3;
  for (int i = threadIdx.x; i < BR * c8; i += MT) {
    const int r = i / c8, c = (i - r * c8) * 8;
    const bool in = r < nrows;
    cp_async16(dst + r * ld + c, in ? src + r * stride + c : src, !in);
  }
}

// The chunk's running sum cs of dt A (two rows a thread; rows past len have
// dt 0, so cs[CMAX - 1] is the chunk's last), dts = dt and the state
// update's weights wts = exp(last - cs) dt.  Returns last.  The caller
// synchronises before reading wts.
__device__ float chunk_scan(const float* __restrict__ dt, size_t crow, int H,
                            int h, int len, float Ah, float* cs, float* dts,
                            float* wts, float* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = 2 * tid;
  const float d0 = r < len ? dt[(crow + r) * H + h] : 0.f;
  const float d1 = r + 1 < len ? dt[(crow + r + 1) * H + h] : 0.f;
  const float a0 = d0 * Ah, a1 = d1 * Ah;
  float v = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) excl += wsum[w];
  cs[r] = excl + a0;
  cs[r + 1] = excl + a0 + a1;
  dts[r] = d0;
  dts[r + 1] = d1;
  __syncthreads();
  const float last = cs[CMAX - 1];
  wts[r] = expf(last - cs[r]) * d0;
  wts[r + 1] = expf(last - cs[r + 1]) * d1;
  return last;
}

// FULL: P == PMAX and N == NMAX (mamba2-1.3b), known at compile time so
// the fragment loops carry no shape guards; otherwise P, N at run time.
template <bool FULL>
__global__ void __launch_bounds__(MT, 2)
ssd_scan_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm,
                    __nv_bfloat16* __restrict__ y,
                    float* __restrict__ state_out, int S, int H, int P, int N,
                    int chunk) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // [BR][LDH] C of block I
  bf16* Bs = Cs + BR * LDH;          // [2][BR][LDH]   B of block J (ring)
  bf16* Sh = Bs + 2 * BR * LDH;      // [PMAX][LDH]    state at chunk entry, hi
  bf16* Sl = Sh + PMAX * LDH;        // [PMAX][LDH]                          lo
  bf16* Xs = Sl + PMAX * LDH;        // [2][BR][LDX]   x of block J (ring)
  float* cs = reinterpret_cast<float*>(Xs + 2 * BR * LDX);  // [CMAX]
  float* dts = cs + CMAX;            // [CMAX] dt
  float* wts = dts + CMAX;           // [CMAX] exp(last - cs) dt
  float* colf = wts + CMAX;          // [CMAX] exp(cs_i0 - cs_j) dt_j, j < i0
  float* wsum = colf + CMAX;         // [32]   scan scratch

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix: lane l addresses row l & 7 of matrix l >> 3
  const int lr = lane & 7, lsel = (lane >> 3) & 1, lhi = lane >> 4;
  const int w16 = warp * 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const float Ah = A[h];
  const size_t brow = (size_t)b * S;   // first (b, s) row of this batch
  const size_t xstride = (size_t)H * P;
  const int KN = FULL ? NMAX / 16 : N / 16;   // k-steps over n
  const int NP = FULL ? PMAX / 8 : P / 8;      // 8-column blocks of p
  const int NN = FULL ? NMAX / 8 : N / 8;      // 8-column blocks of n
  const bool owns_p = w16 < (FULL ? PMAX : P);   // this warp holds state rows

  float st[NMAX / 8][4];               // state rows p = w16 + (g | g+8)
  float acc[PMAX / 8][4];              // y rows i = i0 + w16 + (g | g+8)
  uint32_t cf[NMAX / 16][4];           // C_I fragments (A operand)
  float ci[2];                         // cs of this thread's two rows
  float rf[2];                         // their exp(cs_i - cs_i0)
#pragma unroll
  for (int nb = 0; nb < NMAX / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[nb][e] = 0.f;

  auto fetch = [&](int c, int len_, int Ib, int Jb, int stage, bool c_tile,
                   bool bx_tiles) {
    const size_t crow = brow + c;
    if (c_tile)
      load_tile(Cs, LDH, Cm + (crow + Ib * BR) * N, N, len_ - Ib * BR, N);
    if (bx_tiles) {
      load_tile(Bs + stage * BR * LDH, LDH, Bm + (crow + Jb * BR) * N, N,
                len_ - Jb * BR, N);
      load_tile(Xs + stage * BR * LDX, LDX,
                x + ((crow + Jb * BR) * H + h) * P, xstride, len_ - Jb * BR,
                P);
    }
    cp_async_commit();
  };
  // Row block I visits J = I-1, ..., 0, then the diagonal I: its first
  // step reads the tile of the previous block's last (J = I-1), which
  // stays in its ring stage instead of being loaded again
  auto col = [](int Ib, int k) { return k < Ib ? Ib - 1 - k : Ib; };

  // the step being computed: chunk at c0, row block I, its k-th column
  // block J
  int c0 = 0, I = 0, k = 0, len = min(chunk, S);
  int nI = (len + BR - 1) / BR;
  fetch(0, len, 0, 0, 0, true, true);
  for (int stage = 0;;) {
    const int J = col(I, k);
    const size_t crow = brow + c0;
    if (I == 0 && k == 0) {   // chunk prologue
      const float last = chunk_scan(dt, crow, H, h, len, Ah, cs, dts, wts,
                                    wsum);
      if (owns_p) {
        const float el = expf(last);
#pragma unroll
        for (int nb = 0; nb < NMAX / 8; ++nb) {
          if (nb >= NN) break;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int o = (w16 + g + 8 * hr) * LDH + nb * 8 + 2 * t;
            uint32_t hi, lo;
            split_bf16(st[nb][2 * hr], st[nb][2 * hr + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(Sh + o) = hi;
            *reinterpret_cast<uint32_t*>(Sl + o) = lo;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) st[nb][e] *= el;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // this step's tiles, the prologue's arrays and Sh/Sl

    int nc0 = c0, nIb = I, nk = k + 1, nlen = len;   // the next step
    if (nk > I) {
      nk = 0;
      if (++nIb == nI) {
        nIb = 0;
        nc0 += chunk;
        nlen = min(chunk, S - nc0);
      }
    }
    const bool more = nc0 < S;
    const int nJb = col(nIb, nk);
    const bool reuse = nc0 == c0 && nJb == J;   // same B_J, X_J tiles
    const int i0 = I * BR, j0 = J * BR;
    const bf16* Bt = Bs + stage * BR * LDH;
    const bf16* Xt = Xs + stage * BR * LDX;
    const bool live = i0 + w16 < len;  // this warp has rows of the chunk

    if (k == 0) {
#pragma unroll
      for (int kk = 0; kk < NMAX / 16; ++kk)
        if (kk < KN)
          ldmatrix_x4(cf[kk], Cs + (w16 + (lane & 15)) * LDH + kk * 16 +
                                  lhi * 8);
      ci[0] = cs[i0 + w16 + g];
      ci[1] = cs[i0 + w16 + g + 8];
      // the decay of i >= i0 > j as exp(cs_i - cs_i0) exp(cs_i0 - cs_j):
      // both factors <= 1, the row factor applied once at the diagonal
      const float cs0 = cs[i0];
      for (int j = tid; j < i0; j += MT) colf[j] = expf(cs0 - cs[j]) * dts[j];
      rf[0] = expf(ci[0] - cs0);
      rf[1] = expf(ci[1] - cs0);
      __syncthreads();   // every warp holds C_I: Cs is free; colf is set
    }
    if (more) fetch(nc0, nlen, nIb, nJb, stage ^ 1, nk == 0, !reuse);

    if (k == 0) {   // y_off = exp(cs_i) C_I . St^T
#pragma unroll
      for (int nd = 0; nd < PMAX / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
      if (live && c0 > 0) {
        // the hi pass over all column blocks, then the lo pass: no two
        // neighbouring mma share an accumulator
#pragma unroll
        for (int kk = 0; kk < NMAX / 16; ++kk) {
          if (kk >= KN) break;
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            const bf16* St = part ? Sl : Sh;
            uint32_t sb[PMAX / 16][4];
#pragma unroll
            for (int q = 0; q < PMAX / 16; ++q)
              if (2 * q < NP)
                ldmatrix_x4(sb[q], St + (q * 16 + lr + lhi * 8) * LDH +
                                       kk * 16 + lsel * 8);
#pragma unroll
            for (int q = 0; q < PMAX / 16; ++q)
              if (2 * q < NP) {
                mma_16816(acc[2 * q], cf[kk], sb[q]);
                mma_16816(acc[2 * q + 1], cf[kk], sb[q] + 2);
              }
          }
        }
        const float e0 = expf(cs[i0]);   // times rf at the diagonal
#pragma unroll
        for (int nd = 0; nd < PMAX / 8; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nd][e] *= e0;
      }
    }

    // y_I += (C_I B_J^T o L_IJ dt_J) . X_J, in two halves of J's columns
    // (j0 + 32 hf ...): the exp and split of one half can overlap the
    // other's mma.  On the diagonal (DIAG) a warp stops at its last row.
    auto pair = [&](auto diag_t) {
      constexpr bool DIAG = decltype(diag_t)::value;
      const int nbs = DIAG ? 2 * warp + 2 : BR / 8;   // 8-column blocks
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (4 * hf >= nbs) break;
        float s[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[q][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NMAX / 16; ++kk) {
          if (kk >= KN) break;
#pragma unroll
          for (int q = 0; q < 4; q += 2) {
            const int nb = 4 * hf + q;
            if (nb >= nbs) break;
            uint32_t bb[4];
            ldmatrix_x4(bb, Bt + (nb * 8 + lr + lhi * 8) * LDH + kk * 16 +
                                lsel * 8);
            mma_16816(s[q], cf[kk], bb);
            mma_16816(s[q + 1], cf[kk], bb + 2);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int nb = 4 * hf + q;
          if (nb >= nbs) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + w16 + g + (e >> 1) * 8;
            const int j = j0 + nb * 8 + 2 * t + (e & 1);
            // M = S exp(cs_i - cs_j) dt_j, the exponent taken only where
            // i >= j; off the diagonal without its row factor
            if (DIAG)
              s[q][e] = i >= j ? s[q][e] * expf(ci[e >> 1] - cs[j]) * dts[j]
                               : 0.f;
            else
              s[q][e] *= colf[j];
          }
        }
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          if (4 * hf + 2 * kq >= nbs) break;
          const int kc = 2 * hf + kq;
          uint32_t mh[4], ml[4];
          split_bf16(s[2 * kq][0], s[2 * kq][1], mh[0], ml[0]);
          split_bf16(s[2 * kq][2], s[2 * kq][3], mh[1], ml[1]);
          split_bf16(s[2 * kq + 1][0], s[2 * kq + 1][1], mh[2], ml[2]);
          split_bf16(s[2 * kq + 1][2], s[2 * kq + 1][3], mh[3], ml[3]);
          uint32_t xb[PMAX / 16][4];
#pragma unroll
          for (int q = 0; q < PMAX / 16; ++q)
            if (2 * q < NP)
              ldmatrix_x4_trans(xb[q], Xt + (kc * 16 + lr + lsel * 8) * LDX +
                                           q * 16 + lhi * 8);
#pragma unroll
          for (int part = 0; part < 2; ++part)
#pragma unroll
            for (int q = 0; q < PMAX / 16; ++q)
              if (2 * q < NP) {
                mma_16816(acc[2 * q], part ? ml : mh, xb[q]);
                mma_16816(acc[2 * q + 1], part ? ml : mh, xb[q] + 2);
              }
        }
      }
    };
    if (live) {
      if (J == I) {
#pragma unroll
        for (int nd = 0; nd < PMAX / 8; ++nd) {
          acc[nd][0] *= rf[0];
          acc[nd][1] *= rf[0];
          acc[nd][2] *= rf[1];
          acc[nd][3] *= rf[1];
        }
        pair(std::true_type{});
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {   // block I is complete
          const int i = i0 + w16 + g + 8 * hr;
          if (i >= len) continue;
          bf16* yr = y + ((crow + i) * H + h) * P + 2 * t;
#pragma unroll
          for (int nd = 0; nd < PMAX / 8; ++nd)
            if (nd < NP)
              *reinterpret_cast<__nv_bfloat162*>(yr + nd * 8) =
                  __floats2bfloat162_rn(acc[nd][2 * hr], acc[nd][2 * hr + 1]);
        }
      } else {
        pair(std::false_type{});
      }
    }

    if (I == nI - 1 && owns_p) {   // state += (w o X_J)^T . B_J
#pragma unroll
      for (int kc = 0; kc < BR / 16; ++kc) {
        uint32_t xa[4], ah[4], al[4];
        ldmatrix_x4_trans(xa, Xt + (kc * 16 + lr + lhi * 8) * LDX + w16 +
                                  lsel * 8);
        const int j = j0 + kc * 16 + 2 * t;
        const float wa = wts[j], wb = wts[j + 1];
        const float wc = wts[j + 8], wd = wts[j + 9];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = bf2_floats(xa[r]);
          split_bf16(v.x * (r < 2 ? wa : wc), v.y * (r < 2 ? wb : wd), ah[r],
                     al[r]);
        }
        // groups of 8 column blocks: the hi pass, then the lo pass
#pragma unroll
        for (int g8 = 0; g8 < NMAX / 64; ++g8) {
          if (g8 * 8 >= NN) break;
          uint32_t bb[4][4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (g8 * 8 + 2 * q < NN)
              ldmatrix_x4_trans(bb[q], Bt + (kc * 16 + lr + lsel * 8) * LDH +
                                           g8 * 64 + q * 16 + lhi * 8);
#pragma unroll
          for (int part = 0; part < 2; ++part)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (g8 * 8 + 2 * q < NN) {
                const int nb = g8 * 8 + 2 * q;
                mma_16816(st[nb], part ? al : ah, bb[q]);
                mma_16816(st[nb + 1], part ? al : ah, bb[q] + 2);
              }
        }
      }
    }

    __syncthreads();   // this stage, Sh/Sl and the chunk's arrays are free
    if (!more) break;
    if (!reuse) stage ^= 1;
    c0 = nc0;
    I = nIb;
    k = nk;
    len = nlen;
    nI = (len + BR - 1) / BR;
  }

  if (owns_p) {
    float* out = state_out + ((size_t)b * H + h) * P * N;
#pragma unroll
    for (int nb = 0; nb < NMAX / 8; ++nb) {
      if (nb >= NN) break;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(out + (w16 + g + 8 * hr) * N + nb * 8 +
                                   2 * t) =
            make_float2(st[nb][2 * hr], st[nb][2 * hr + 1]);
    }
  }
}

cudaError_t launch_mma(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, void* state,
                       int B, int S, int H, int P, int N, int chunk,
                       cudaStream_t stream) {
  auto kern = P == PMAX && N == NMAX ? ssd_scan_mma_kernel<true>
                                     : ssd_scan_mma_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MMA_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  kern<<<grid, MT, MMA_SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(state), S, H, P, N, chunk);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 = launched).  Does not synchronize.  The
// route is the wrapper's choice; one it cannot take is refused, never
// replaced by the other.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            void* state, int dtype, int route, int B, int S,
                            int H, int P, int N, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || P <= 0 || P > PMAX ||
      P % 4 || N <= 0 || N > NMAX || N % 4 || chunk <= 0 || chunk > CMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_MMA) {
    if (dtype != kBF16 || P % 16 || N % 16) return (int)cudaErrorInvalidValue;
    return (int)launch_mma(x, dt, A, Bm, Cm, y, state, B, S, H, P, N, chunk,
                           s);
  }
  if (route != ROUTE_CUDA_CORE) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return (int)launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, S, H,
                                      P, N, chunk, s);
  if (dtype == kF32)
    return (int)launch<float>(x, dt, A, Bm, Cm, y, state, B, S, H, P, N,
                              chunk, s);
  return (int)cudaErrorInvalidValue;
}
