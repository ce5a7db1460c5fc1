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
// output in q's dtype.  Any cap is taken.  The position is read from device
// memory, so a decode step needs no host round trip.
//
// What bounds it on the H100: bytes.  recurrentgemma-9b's decode (B 8,
// cap 2048, 16 q heads over 1 kv head, hd 256, bf16) reads 16.8 MB of k/v,
// 5.0 us at 3.35 TB/s, and does 4*B*Hq*hd FLOP per kept slot (0.27 GFLOP),
// far below the compute bound.  To reach the byte rate the call needs
// enough CTAs on the 132 SMs and enough bytes in flight in each.  One CTA
// per (lane, kv head) walking the whole cache is 8 CTAs at that shape.
//
// Design (flash-decoding, merged in one launch):
//  * split: grid (cluster, Hkv, B).  The CTAs of one (kv head, lane) form a
//    thread-block cluster (up to 16, non-portable above 8); CTA r takes
//    slots [r*chunk, (r+1)*chunk).  chunk and the cluster size come from
//    split_plan in kernels/decode_attention/ops.py, which sizes the split so
//    that the CTAs cover the card where one cluster per (lane, kv head) can.
//  * loads in flight: each CTA first turns kv_pos into one keep bit per
//    slot of its range (a warp ballot per 32 slots, in shared memory), then
//    walks its slots in blocks of BS (16 KB of k and 16 KB of v at most)
//    through a ring of NST stages filled by 16-byte cp.async copies, so
//    blocks i+1 and i+2 arrive while block i is computed.  A block with no
//    kept slot is never loaded; a masked slot inside a live block is
//    zero-filled without reading memory.  Rows are stored with their
//    16-byte chunks XOR-swizzled by the row, so ldmatrix and 16-byte shared
//    loads are free of bank conflicts.  Shared memory stays under 113 KB,
//    so two CTAs fit an SM at hd 256.
//  * latency, not bytes, is what is left: a call whose slots are all masked
//    takes 5.7-7.2 us on the H100 (launch, kv_pos, merge), and each block
//    is a chain of dependent products.  The scores' k-steps are therefore
//    split over two accumulators, and their k fragments come two k-steps
//    per ldmatrix.x4.
//  * bf16 on tensor cores (mma.sync m16n8k16): the G <= 16 query heads of
//    the kv head are the 16 M rows (zero-padded when G < 16).  wgmma would
//    need 64 M rows, so at least 3/4 of every product would be padding.
//    The q fragments stay in registers for the whole call.  Scores: each
//    warp takes BS/4 slots of the block, its k fragments by ldmatrix.  They
//    go through a small shared tile; every warp then runs the same online
//    softmax on all BS slots (same inputs, same order, so the same bits)
//    and multiplies p (rounded to bf16, as the plain version does) by its
//    own quarter of v's columns, read by ldmatrix.trans: no transposed copy
//    of v is made.
//  * f32 stays on the CUDA cores in full f32 (never TF32): a thread per
//    (slot, head subset) for the scores, a warp per head for the
//    statistics, threads over output columns for p.v.
//  * merge: each CTA leaves its partial (m, l, acc[G][hd]) in f32 in its own
//    shared memory; after cluster.sync() every CTA merges one slice of the
//    G x hd outputs from all its peers' partials through distributed shared
//    memory (cluster.map_shared_rank) and writes it.  A CTA whose slots are
//    all masked contributes m = -inf, l = 0 and weight 0 (no NaN).  The
//    peers are summed in rank order and nothing is atomic, so two calls on
//    the same inputs give the same bits; there is no second launch and no
//    global scratch.
//
// Paged entry (decode_attention_paged_fwd), the serving engine's decode:
// the same function as gathering each lane's cache through its block-table
// row (src/repro/serve/kvcache.py:gather_lane_cache) and running the dense
// decode on it, computed without the gather.  k/v pools (NP, ps, Hkv, hd)
// and kv_pos pool (NP, ps) are one layer's views of the stacked pool: a
// page is ps contiguous rows, pages lie kv_pstride (pos_pstride) elements
// apart.  block_table (B, max_blocks) maps a lane's logical page to a
// physical one (-1 unmapped); pos (B,) is each lane's query position.  The
// split runs over the logical cap max_blocks * ps, as the dense split runs
// over the ring; each CTA first stages the table entries of its slot range
// in shared memory, and then a slot's row is phys * kv_pstride + (j % ps)
// rows: the keep-bit pass reads kv_pos through it, the loads read k/v
// through it.  An unmapped page's slots are never kept and never read, so
// a lane with bt[b, 0] < 0 (inactive) keeps no slot and writes zeros, and
// a pos past the mapped span needs no check.  Everything after the keep
// bits (ring, products, softmax, cluster merge) is the dense kernel's.
#include <math.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace repro;

constexpr int NT = 128;               // threads per CTA
constexpr int NW = NT / 32;           // warps
constexpr int GMAX = 16;              // most query heads per kv head
constexpr int MAX_CLUSTER = 16;       // CTAs per (kv head, lane)
constexpr int MAX_CHUNK = 32768;      // slots per CTA (one keep bit each)
constexpr int CHUNK_GRANULE = 64;     // ops.py: split_plan's slot granule
constexpr int BT_STAGE = 1024;        // ops.py: BT_STAGE, table entries a CTA

template <typename T, int HD>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int ELEM = 16 / (int)sizeof(T);      // elements per chunk
  static constexpr int CH = HD / ELEM;                  // chunks per row
  static constexpr int SWZ = (CH < 8 ? CH : 8) - 1;     // chunk swizzle mask
  // slots per block: 16 KB of k (and of v), at most 64
  static constexpr int BS_BYTES = 16384 / (HD * (int)sizeof(T));
  static constexpr int BS = BS_BYTES < 64 ? BS_BYTES : 64;
  static constexpr int NST = F32 ? 2 : 3;               // ring stages
  static constexpr int SS = BS + 4;                     // score row stride
  static constexpr size_t RING = (size_t)NST * 2 * BS * HD * sizeof(T);
  static constexpr size_t SCORES = sizeof(float) * GMAX * SS;
  static constexpr size_t QS = F32 ? sizeof(float) * GMAX * HD : 0;
  static constexpr size_t MISC =
      sizeof(float) * (3 * GMAX + MAX_CLUSTER * GMAX) + MAX_CHUNK / 8;
  static constexpr size_t SMEM = RING + SCORES + QS + MISC;
  static constexpr size_t SMEM_PAGED = SMEM + sizeof(int) * BT_STAGE;
  static_assert(CHUNK_GRANULE % BS == 0, "a chunk is whole blocks");
  static_assert(sizeof(float) * GMAX * HD <= RING, "acc_s aliases the ring");
  static_assert(SMEM_PAGED <= 113 * 1024, "two CTAs per SM");
};

// The paged entry's extra operands (unused by the dense entry).
struct PagedArgs {
  const int* bt;           // (B, max_blocks) logical -> physical page
  int max_blocks, ps;      // table width, slots per page
  long long kv_pstride;    // elements between two pages of k (and of v)
  long long pos_pstride;   // elements between two pages of kv_pos
};

template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_pos,
                    const int* __restrict__ pos_ptr, T* __restrict__ o,
                    int cap, int Hq, int Hkv, int window, float softcap,
                    float scale, int chunk, PagedArgs pg) {
  using C = Cfg<T, HD>;
  constexpr int BS = C::BS, CH = C::CH, SWZ = C::SWZ, ELEM = C::ELEM;
  constexpr int NST = C::NST, SS = C::SS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);         // [NST][k|v][BS][HD]
  float* s_s = reinterpret_cast<float*>(smem + C::RING);   // [GMAX][SS]
  float* q_s = s_s + GMAX * SS;                 // [GMAX][HD], f32 path
  float* m_s = q_s + (C::F32 ? GMAX * HD : 0);  // [GMAX] partial max
  float* l_s = m_s + GMAX;                      // [GMAX] partial sum
  float* L_s = l_s + GMAX;                      // [GMAX] merged sum
  float* w_s = L_s + GMAX;                      // [MAX_CLUSTER][GMAX]
  // keep bit of each of the CTA's slots (bit j - s0)
  unsigned* keep = reinterpret_cast<unsigned*>(w_s + MAX_CLUSTER * GMAX);
  // paged: the table entries of this CTA's pages (entry i is page lp0 + i)
  int* bt_s = reinterpret_cast<int*>(keep + MAX_CHUNK / 32);
  float* acc_s = reinterpret_cast<float*>(smem);  // [GMAX][HD] after the walk

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nclu = (int)cluster.num_blocks();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int pos = PAGED ? pos_ptr[b] : *pos_ptr;
  const int s0 = rank * chunk, s1 = min(cap, s0 + chunk);
  const int nb = s1 > s0 ? (s1 - s0 + BS - 1) / BS : 0;
  const int lp0 = PAGED ? s0 / pg.ps : 0;
  bool live = true;        // paged: the lane is active (bt[b, 0] >= 0)
  if constexpr (PAGED) {
    const int* row = pg.bt + (size_t)b * pg.max_blocks;
    live = row[0] >= 0;
    const int npg = s1 > s0 ? (s1 - 1) / pg.ps - lp0 + 1 : 0;
    for (int i = tid; i < npg; i += NT) bt_s[i] = row[lp0 + i];
    __syncthreads();
  }
  // physical page of logical slot j of this CTA (paged), -1 if unmapped
  auto page_of = [&](int j) { return live ? bt_s[j / pg.ps - lp0] : -1; };

  auto keep_slot = [&](int j) {
    int kp;
    if constexpr (PAGED) {
      const int phys = page_of(j);
      if (phys < 0) return false;
      kp = kv_pos[(size_t)phys * pg.pos_pstride + j % pg.ps];
    } else {
      kp = kv_pos[j];
    }
    return kp <= pos && (window <= 0 || pos - kp < window);
  };

  // ---- bf16 state: q fragments (loaded first, so that their latency
  // overlaps the live-bit pass), running (m, l) of rows g and g+8, and this
  // warp's columns of the output accumulator
  const T* qb = q + ((size_t)b * Hq + hk * G) * HD;
  const int g = lane >> 2, t = lane & 3;
  constexpr int KD = HD / 16;                    // k-steps of q.k
  constexpr int SW = BS / NW;                    // score slots per warp
  constexpr int NS = SW / 8;                     // their 8-slot tiles
  constexpr int NCW = HD / 8 < NW ? HD / 8 : NW; // warps owning columns
  constexpr int CW = HD / NCW;                   // columns per such warp
  constexpr int ND = C::F32 ? 1 : CW / 8;        // their 8-column tiles
  constexpr int KC = BS / 16;                    // k-steps of p.v
  uint32_t qf[C::F32 ? 1 : KD][4];
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  if constexpr (!C::F32) {
    auto ld = [&](int row, int col) -> uint32_t {
      return row < G ? *reinterpret_cast<const uint32_t*>(qb + row * HD + col)
                     : 0u;
    };
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qf[kk][0] = ld(g, kk * 16 + 2 * t);
      qf[kk][1] = ld(g + 8, kk * 16 + 2 * t);
      qf[kk][2] = ld(g, kk * 16 + 2 * t + 8);
      qf[kk][3] = ld(g + 8, kk * 16 + 2 * t + 8);
    }
  }
  // keep bits of this CTA's slots, a warp ballot per 32 slots (chunk and s0
  // are multiples of 64), no atomics; the walk reads only these bits
  if (tid < GMAX) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  if constexpr (C::F32) {
    for (int i = tid; i < GMAX * HD; i += NT)
      q_s[i] = i / HD < G ? qb[i] : 0.f;
  }
  const int nslot = s1 > s0 ? s1 - s0 : 0;
  for (int base = 0; base < nslot; base += NT) {
    const int jj = base + tid;
    const unsigned bits = __ballot_sync(0xffffffffu,
                                        jj < nslot && keep_slot(s0 + jj));
    if (lane == 0 && base + warp * 32 < nslot) keep[(base >> 5) + warp] = bits;
  }
  __syncthreads();
  // slot s0 + jj (jj < nslot) takes part
  auto kept_bit = [&](int jj) { return (keep[jj >> 5] >> (jj & 31)) & 1u; };
  // a block is live when any of its BS (16, 32 or 64) slots is kept
  auto next_live = [&](int i) {
    for (; i < nb; ++i) {
      const int w = (i * BS) >> 5;
      const unsigned bits =
          BS == 64 ? keep[w] | (i * BS + 32 < nslot ? keep[w + 1] : 0u)
          : BS == 32 ? keep[w]
                     : (keep[w] >> ((i * BS) & 31)) & 0xffffu;
      if (bits) break;
    }
    return i;
  };
  // block i of this CTA into ring stage st: kept slots copied, the rest
  // (masked, or past the CTA's slots) zero-filled without a read
  auto load_block = [&](int i, int st) {
    T* ks = ring + (size_t)st * 2 * BS * HD;
    T* vs = ks + BS * HD;
    const int j0 = s0 + i * BS;
    for (int idx = tid; idx < BS * CH; idx += NT) {
      const int r = idx / CH, c = idx % CH, j = j0 + r;
      const bool kept = j < s1 && kept_bit(j - s0);
      size_t off = 0;
      if (kept) {
        if constexpr (PAGED)
          off = (size_t)page_of(j) * pg.kv_pstride +
                ((size_t)(j % pg.ps) * Hkv + hk) * HD + c * ELEM;
        else
          off = ((size_t)(b * cap + j) * Hkv + hk) * HD + c * ELEM;
      }
      const int dst = r * HD + (c ^ (r & SWZ)) * ELEM;
      cp_async16(ks + dst, k + off, !kept);
      cp_async16(vs + dst, v + off, !kept);
    }
  };

  // ---- f32 state: threads over (slot, head subset) and output columns
  constexpr int NHS = NT / BS;                   // head subsets in the scores
  constexpr int R = HD >= NT ? 1 : NT / HD;      // slot subsets in p.v
  constexpr int COLS = HD >= NT ? HD / NT : 1;   // columns per thread in p.v
  const int sc = tid % BS, hs = tid / BS;
  const int d0 = tid % (NT / R), r0 = tid / (NT / R);
  float facc[C::F32 ? GMAX : 1][COLS];
#pragma unroll
  for (int i = 0; i < (C::F32 ? GMAX : 1); ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) facc[i][c] = 0.f;

  // ---- the walk: NST-1 live blocks in flight ahead of the one computed
  int issue = next_live(0);
#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (issue < nb) {
      load_block(issue, st);
      issue = next_live(issue + 1);
    }
    cp_async_commit();
  }
  int stage = 0;
  for (int cur = next_live(0); cur < nb; cur = next_live(cur + 1)) {
    if (issue < nb) {
      load_block(issue, (stage + NST - 1) % NST);
      issue = next_live(issue + 1);
    }
    cp_async_commit();
    cp_async_wait<NST - 1>();
    __syncthreads();
    const T* ks = ring + (size_t)stage * 2 * BS * HD;
    const T* vs = ks + BS * HD;
    const int j0 = s0 + cur * BS;

    if constexpr (!C::F32) {
      // scores of this warp's slots: S[16 heads][SW slots], the k-steps
      // split over two accumulators (half the dependent mma chain), two
      // k-steps of k fragments per ldmatrix.x4
      float s[NS][4], s2[NS][4];
#pragma unroll
      for (int ns = 0; ns < NS; ++ns)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[ns][e] = s2[ns][e] = 0.f;
#pragma unroll
      for (int ns = 0; ns < NS; ++ns) {
        const int r = warp * SW + ns * 8 + (lane & 7);
        if constexpr (KD % 2 == 0) {
#pragma unroll
          for (int kk = 0; kk < KD; kk += 2) {
            const int c = 2 * kk + (lane >> 3);
            uint32_t bfr[4];
            ldmatrix_x4(bfr, ks + r * HD + (c ^ (r & SWZ)) * ELEM);
            mma_16816(s[ns], qf[kk], bfr);
            mma_16816(s2[ns], qf[kk + 1], bfr + 2);
          }
        } else {
          const int c = (lane >> 3) & 1;
          uint32_t bfr[2];
          ldmatrix_x2(bfr, ks + r * HD + (c ^ (r & SWZ)) * ELEM);
          mma_16816(s[ns], qf[0], bfr);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) s[ns][e] += s2[ns][e];
      }
#pragma unroll
      for (int ns = 0; ns < NS; ++ns) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jb = warp * SW + ns * 8 + 2 * t + (e & 1);
          const int j = j0 + jb;
          float x = s[ns][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          s_s[(g + 8 * (e >> 1)) * SS + jb] =
              j < s1 && kept_bit(j - s0) ? x : -INFINITY;
        }
      }
      __syncthreads();
      // online softmax over the block, rows g and g+8 (every warp alike);
      // x[kc][r] holds the A-fragment register r of p.v's k-step kc
      float x[KC][4][2], bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            x[kc][r][e] = s_s[(g + 8 * (r & 1)) * SS + kc * 16 + 8 * (r >> 1) +
                              2 * t + e];
            bm[r & 1] = fmaxf(bm[r & 1], x[kc][r][e]);
          }
      float alpha[2], msafe[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bm[i] = fmaxf(bm[i], __shfl_xor_sync(0xffffffffu, bm[i], 1));
        bm[i] = fmaxf(bm[i], __shfl_xor_sync(0xffffffffu, bm[i], 2));
        const float mnew = fmaxf(m_r[i], bm[i]);
        msafe[i] = mnew == -INFINITY ? 0.f : mnew;
        alpha[i] = expf(m_r[i] - msafe[i]);
        m_r[i] = mnew;
      }
      uint32_t pa[KC][4];
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p0 = expf(x[kc][r][0] - msafe[r & 1]);
          const float p1 = expf(x[kc][r][1] - msafe[r & 1]);
          rs[r & 1] += p0 + p1;
          pa[kc][r] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l_r[i] = l_r[i] * alpha[i] + rs[i];
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        acc[nd][0] *= alpha[0];
        acc[nd][1] *= alpha[0];
        acc[nd][2] *= alpha[1];
        acc[nd][3] *= alpha[1];
      }
      // p.v on this warp's columns
      if (warp < NCW) {
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          const int c = (warp * CW + nd * 8) / ELEM;
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            const int r = kc * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
            uint32_t bfr[2];
            ldmatrix_x2_trans(bfr, vs + r * HD + (c ^ (r & SWZ)) * ELEM);
            mma_16816(acc[nd], pa[kc], bfr);
          }
        }
      }
    } else {
      // scores: thread (slot sc, head subset hs) covers heads hs, hs+NHS, ..
      const int j = j0 + sc;
      const bool kept = j < s1 && kept_bit(j - s0);
      float sa[GMAX / NHS];
#pragma unroll
      for (int i = 0; i < GMAX / NHS; ++i) sa[i] = 0.f;
      if (kept) {
#pragma unroll 4
        for (int c = 0; c < CH; ++c) {
          const float4 kv4 = *reinterpret_cast<const float4*>(
              ks + sc * HD + (c ^ (sc & SWZ)) * ELEM);
#pragma unroll
          for (int i = 0; i < GMAX / NHS; ++i) {
            const int gg = hs + i * NHS;
            if (gg < G) {
              const float* qr = q_s + gg * HD + c * 4;
              sa[i] = fmaf(qr[0], kv4.x, sa[i]);
              sa[i] = fmaf(qr[1], kv4.y, sa[i]);
              sa[i] = fmaf(qr[2], kv4.z, sa[i]);
              sa[i] = fmaf(qr[3], kv4.w, sa[i]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < GMAX / NHS; ++i) {
        const int gg = hs + i * NHS;
        if (gg < G) {
          float xx = sa[i] * scale;
          if (softcap > 0.f) xx = softcap * tanhf(xx / softcap);
          s_s[gg * SS + sc] = kept ? xx : -INFINITY;
        }
      }
      __syncthreads();
      // statistics: one warp per head; p overwrites the scores, alpha goes
      // to w_s (free until the merge)
      for (int gg = warp; gg < G; gg += NW) {
        constexpr int PL = (BS + 31) / 32;
        float xs[PL], tmax = -INFINITY;
#pragma unroll
        for (int i = 0; i < PL; ++i) {
          const int jj = lane + 32 * i;
          xs[i] = jj < BS ? s_s[gg * SS + jj] : -INFINITY;
          tmax = fmaxf(tmax, xs[i]);
        }
        tmax = warp_max(tmax);
        const float mold = m_s[gg];
        const float mnew = fmaxf(mold, tmax);
        const float ms = mnew == -INFINITY ? 0.f : mnew;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < PL; ++i) {
          const int jj = lane + 32 * i;
          const float p = expf(xs[i] - ms);
          if (jj < BS) s_s[gg * SS + jj] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        __syncwarp();
        if (lane == 0) {
          const float a = expf(mold - ms);
          w_s[gg] = a;
          l_s[gg] = l_s[gg] * a + sum;
          m_s[gg] = mnew;
        }
      }
      __syncthreads();
#pragma unroll
      for (int gg = 0; gg < GMAX; ++gg) {
        if (gg < G) {
#pragma unroll
          for (int c = 0; c < COLS; ++c) facc[gg][c] *= w_s[gg];
        }
      }
#pragma unroll 4
      for (int jj = r0; jj < BS; jj += R) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const int d = d0 + c * NT;
          const float vv =
              vs[jj * HD + ((d / ELEM) ^ (jj & SWZ)) * ELEM + d % ELEM];
#pragma unroll
          for (int gg = 0; gg < GMAX; ++gg)
            if (gg < G) facc[gg][c] = fmaf(s_s[gg * SS + jj], vv, facc[gg][c]);
        }
      }
    }
    __syncthreads();   // the stage is consumed before it is refilled
    stage = (stage + 1) % NST;
  }
  cp_async_wait<0>();
  __syncthreads();     // the ring is drained: acc_s may alias it

  // ---- this CTA's partial: acc_s[G][HD], m_s, l_s
  if constexpr (!C::F32) {
    if (warp < NCW) {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = g + 8 * (e >> 1);
          if (row < G)
            acc_s[row * HD + warp * CW + nd * 8 + 2 * t + (e & 1)] = acc[nd][e];
        }
    }
    if (warp == 0 && t == 0) {
      if (g < G) {
        m_s[g] = m_r[0];
        l_s[g] = l_r[0];
      }
      if (g + 8 < G) {
        m_s[g + 8] = m_r[1];
        l_s[g + 8] = l_r[1];
      }
    }
  } else {
    // slot subsets summed in a fixed order
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      if (r0 == r) {
#pragma unroll
        for (int gg = 0; gg < GMAX; ++gg) {
          if (gg < G) {
#pragma unroll
            for (int c = 0; c < COLS; ++c) {
              float* a = acc_s + gg * HD + d0 + c * NT;
              *a = r == 0 ? facc[gg][c] : *a + facc[gg][c];
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- merge across the cluster (distributed shared memory); every peer's
  // value is read before any is used, so the remote loads are in flight
  // together, and summed in rank order
  cluster.sync();
  if (tid < G) {
    float mp[MAX_CLUSTER], lp[MAX_CLUSTER];
#pragma unroll
    for (int p = 0; p < MAX_CLUSTER; ++p) {
      mp[p] = p < nclu ? *cluster.map_shared_rank(m_s + tid, p) : -INFINITY;
      lp[p] = p < nclu ? *cluster.map_shared_rank(l_s + tid, p) : 0.f;
    }
    float M = -INFINITY;
#pragma unroll
    for (int p = 0; p < MAX_CLUSTER; ++p) M = fmaxf(M, mp[p]);
    const float Ms = M == -INFINITY ? 0.f : M;
    float L = 0.f;
#pragma unroll
    for (int p = 0; p < MAX_CLUSTER; ++p) {
      const float w = mp[p] == -INFINITY ? 0.f : expf(mp[p] - Ms);
      w_s[p * GMAX + tid] = w;
      L += w * lp[p];
    }
    L_s[tid] = L;
  }
  __syncthreads();
  const int E4 = G * HD / 4;
  const int per = (E4 + nclu - 1) / nclu;
  const int e_end = min(E4, (rank + 1) * per);
  for (int e = rank * per + tid; e < e_end; e += NT) {
    const int gg = (4 * e) / HD, d = (4 * e) % HD;
    float4 a[MAX_CLUSTER];
#pragma unroll
    for (int p = 0; p < MAX_CLUSTER; ++p)
      if (p < nclu && w_s[p * GMAX + gg] != 0.f)
        a[p] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(acc_s + gg * HD + d, p));
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < MAX_CLUSTER; ++p) {
      const float w = p < nclu ? w_s[p * GMAX + gg] : 0.f;
      if (w != 0.f) {
        sum.x = fmaf(w, a[p].x, sum.x);
        sum.y = fmaf(w, a[p].y, sum.y);
        sum.z = fmaf(w, a[p].z, sum.z);
        sum.w = fmaf(w, a[p].w, sum.w);
      }
    }
    const float L = L_s[gg];
    T* orow = o + ((size_t)b * Hq + hk * G + gg) * HD + d;
    orow[0] = from_f<T>(L > 0.f ? sum.x / L : 0.f);
    orow[1] = from_f<T>(L > 0.f ? sum.y / L : 0.f);
    orow[2] = from_f<T>(L > 0.f ? sum.z / L : 0.f);
    orow[3] = from_f<T>(L > 0.f ? sum.w / L : 0.f);
  }
  cluster.sync();      // no CTA leaves while a peer reads its partial
}

template <typename T, int HD, bool PAGED>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_pos, const int* pos, void* o, int B, int cap,
                   int Hq, int Hkv, int window, float softcap, int chunk,
                   int nclu, PagedArgs pg, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  constexpr size_t smem = PAGED ? C::SMEM_PAGED : C::SMEM;
  if (chunk <= 0 || chunk % CHUNK_GRANULE || chunk > MAX_CHUNK || nclu < 1 ||
      nclu > MAX_CLUSTER || (long long)(nclu - 1) * chunk >= cap ||
      (long long)nclu * chunk < cap)
    return cudaErrorInvalidValue;
  auto kern = decode_split_kernel<T, HD, PAGED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && nclu > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nclu, Hkv, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nclu;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           kv_pos, pos, static_cast<T*>(o), cap, Hq, Hkv,
                           window, softcap, 1.0f / sqrtf((float)HD), chunk,
                           pg);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool PAGED>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* kv_pos, const int* pos, void* o, int B,
                        int cap, int Hq, int Hkv, int window, float softcap,
                        int chunk, int nclu, PagedArgs pg, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16, PAGED>(q, k, v, kv_pos, pos, o, B, cap, Hq, Hkv, window, softcap, chunk, nclu, pg, s);
    case 32: return launch<T, 32, PAGED>(q, k, v, kv_pos, pos, o, B, cap, Hq, Hkv, window, softcap, chunk, nclu, pg, s);
    case 64: return launch<T, 64, PAGED>(q, k, v, kv_pos, pos, o, B, cap, Hq, Hkv, window, softcap, chunk, nclu, pg, s);
    case 128: return launch<T, 128, PAGED>(q, k, v, kv_pos, pos, o, B, cap, Hq, Hkv, window, softcap, chunk, nclu, pg, s);
    case 256: return launch<T, 256, PAGED>(q, k, v, kv_pos, pos, o, B, cap, Hq, Hkv, window, softcap, chunk, nclu, pg, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool PAGED>
int dispatch(int dtype, int hd, const void* q, const void* k, const void* v,
             const void* kv_pos, const void* pos, void* o, int B, int cap,
             int Hq, int Hkv, int window, float softcap, int chunk, int nclu,
             PagedArgs pg, void* stream) {
  if (B <= 0 || cap <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > GMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kp = static_cast<const int*>(kv_pos);
  const int* p = static_cast<const int*>(pos);
  if (dtype == kBF16)
    return (int)dispatch_hd<__nv_bfloat16, PAGED>(hd, q, k, v, kp, p, o, B,
                                                  cap, Hq, Hkv, window,
                                                  softcap, chunk, nclu, pg, s);
  if (dtype == kF32)
    return (int)dispatch_hd<float, PAGED>(hd, q, k, v, kp, p, o, B, cap, Hq,
                                          Hkv, window, softcap, chunk, nclu,
                                          pg, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns a cudaError_t code (0 = launched).  Does not synchronize.  chunk
// (slots per CTA, a multiple of 64) and nclu (CTAs per cluster, 1-16, with
// (nclu - 1) * chunk < cap <= nclu * chunk) come from ops.py: split_plan.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* kv_pos,
                                    const void* pos, void* o, int dtype, int B,
                                    int cap, int Hq, int Hkv, int hd,
                                    int window, float softcap, int chunk,
                                    int nclu, void* stream) {
  return dispatch<false>(dtype, hd, q, k, v, kv_pos, pos, o, B, cap, Hq, Hkv,
                         window, softcap, chunk, nclu,
                         PagedArgs{nullptr, 0, 1, 0, 0}, stream);
}

// The paged entry: q (B,1,Hq,hd) and o contiguous; k_pool/v_pool
// (NP, ps, Hkv, hd) and kv_pos_pool (NP, ps) contiguous within a page, pages
// kv_pstride / pos_pstride elements apart; block_table (B, max_blocks) and
// pos (B,) int32.  chunk and nclu come from split_plan over the logical cap
// max_blocks * ps, and a CTA's pages must fit BT_STAGE:
// (chunk - 1) / ps + 2 <= BT_STAGE.
extern "C" int decode_attention_paged_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* kv_pos_pool, const void* block_table, const void* pos,
    void* o, int dtype, int B, int max_blocks, int ps, int Hq, int Hkv,
    int hd, long long kv_pstride, long long pos_pstride, int window,
    float softcap, int chunk, int nclu, void* stream) {
  if (max_blocks <= 0 || ps <= 0 || (chunk - 1) / ps + 2 > BT_STAGE ||
      kv_pstride < (long long)ps * Hkv * hd || pos_pstride < ps)
    return (int)cudaErrorInvalidValue;
  return dispatch<true>(dtype, hd, q, k_pool, v_pool, kv_pos_pool, pos, o, B,
                        max_blocks * ps, Hq, Hkv, window, softcap, chunk, nclu,
                        PagedArgs{static_cast<const int*>(block_table),
                                  max_blocks, ps, kv_pstride, pos_pstride},
                        stream);
}
