// K4: the RG-LRU linear recurrence, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan/kernel.py
// (_rglru_kernel / rglru_scan_fwd).  Same function: given the gates
// a, b (B,S,W) f32, h_t = a_t h_{t-1} + b_t from h_{-1} = 0; writes h
// (B,S,W) f32 and the final h (B,W) f32.
//
// What bounds it on the H100: bytes.  At the serving path's shape (B=8,
// S=2560, W=4096) it reads a and b and writes h, three f32 arrays of
// 335.5 MB, about 0.30 ms at 3.35 TB/s; it does 2 FLOP per element.
//
// Design (simple and correct first):
//  * one thread per (b, w) channel walks S in order (the TPU's sequential
//    grid axis becomes that loop); neighbouring threads hold neighbouring
//    w, so every load and store is coalesced.
//  * 8 x 4096 channels are 32768 threads, about 8 warps an SM: too few to
//    hide memory latency one timestep at a time.  So each thread keeps the
//    loads of the next U timesteps in flight (registers) while it runs the
//    FMA chain of the current U.
//  * no S or W block multiples: the loads past S are predicated, the
//    threads past W return.  A chunked two-pass scan across S, for more
//    parallelism, comes later.
#include "common.cuh"

namespace {

constexpr int NT = 128;   // threads per CTA (channels)
constexpr int U = 16;     // timesteps per prefetched group

__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, float* __restrict__ h_final, int S,
                  int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  float ca[U], cb[U], na[U], nb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = u < S;
    ca[u] = in ? __ldcs(a + base + (size_t)u * W) : 0.f;
    cb[u] = in ? __ldcs(b + base + (size_t)u * W) : 0.f;
  }
  float hv = 0.f;
  for (int t0 = 0; t0 < S; t0 += U) {
    const int t1 = t0 + U;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = t1 + u < S;
      na[u] = in ? __ldcs(a + base + (size_t)(t1 + u) * W) : 0.f;
      nb[u] = in ? __ldcs(b + base + (size_t)(t1 + u) * W) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        hv = fmaf(ca[u], hv, cb[u]);
        __stcs(h + base + (size_t)(t0 + u) * W, hv);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
  h_final[(size_t)blockIdx.y * W + w] = hv;
}

}  // namespace

// Returns a cudaError_t code (0 = launched).  Does not synchronize.
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h,
                              void* h_final, int B, int S, int W,
                              void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + NT - 1) / NT, B);
  rglru_scan_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), static_cast<float*>(h_final), S, W);
  return (int)cudaGetLastError();
}
