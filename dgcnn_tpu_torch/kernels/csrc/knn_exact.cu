// Flat FP32-exact k-nearest-neighbour selection for Hopper (sm_90a).
//
// Replaces dgcnn_tpu/kernels/knn_pallas.py::_knn_kernel (launched from
// _knn_pallas_jit through knn_pallas(packed=False), with or without
// `queries`). It computes exactly what that kernel computes:
//
//   score(q, o) = 2 * <q, x_o> - |x_o|^2                (FP32, FMA dot; no
//                                                         -|q|^2 term;
//                                                         knn_common.cuh)
//   the k largest scores in descending order, ties to the LOWER row o
//   (lax.top_k's order), exact on these FP32 scores: no key packing.
//
// The port calls it for the stage-1 band-edge repair (at most 256 queries
// per batch element, against N rows), as the capped kNN's fallback past 15
// index bits (a self-kNN over more than 32768 rows), as the packed kNN's
// and as the parity wrapper's flat fallback.
//
// What bounds it on the H100: M*N*C FP32 FMAs per batch element plus one
// compare per pair against the running k-th entry, and the rows' bytes.
// No tensor-core work (FP32 policy). What held the first design (a warp
// per query reading every row from L1 / L2 in ascending order) back was
// neither: (1) a query in the middle of an x-sorted cloud (the repair's
// failing rows) met nearer and nearer rows all the way to itself, ~1000
// insertions, each a chain of dependent warp steps, against ~120 when the
// walk starts at the query's own row; (2) each warp read the whole cloud
// through L2 (at the repair's shape 2048 warps x 140 KB), which alone took
// 0.045 ms.
//
// Design. A warp walks a query's rows 32 at a time (a chunk: one row a
// lane). The warp's sorted top-k list lives in registers across the
// lanes: entry j in lane j % 32, slot j / 32 (two slots for k <= 64). A
// lane whose row ranks ahead of the k-th entry raises its ballot bit.
//
// * Visiting order. With a row hint (`rows`, (B, M): the row each query
//   sits at, in an x-sorted cloud) the walk starts at the query's own
//   chunk c0 and goes right, c0 + 1, c0 + 2, ..., then left from c0 - 1
//   down to chunk 0: on either side the rows come nearest first. Without
//   a hint it starts at chunk 0, i.e. ascending. (score, row) is a total
//   order (`ahead`), so the order changes no output.
// * Rows in shared memory (C <= 8, knn_exact_kernel_cloud). A block of 32
//   warps holds queries of one cloud and stages the cloud's rows and norms
//   where they fit (7000 rows of C=4 take 140 KB), by two bulk copies of
//   the copy engine, so L2 serves each row once a block, not once a query.
// * Winners kept pending. A one-slot list (k <= 32) appends the rows that
//   beat its k-th entry to a buffer and merges 32 at a time by bitonic
//   networks (flush_pending), where one insertion after another cost seven
//   dependent warp shuffles each.
// * Pruning (the same kernel). Where the staged rows are sorted by channel
//   0, as the repair's x-sorted clouds are, a chunk whose nearest row in
//   channel 0 is already out of reach of the list's k-th entry ends the
//   walk on its side: about 30 of the repair's 219 chunks are scored.
// * Slices. `slices` (S, a power of two up to 8) warps share a query: warp
//   s takes the walk's steps s, s + S, s + 2S, ... A block holds 32 / S
//   queries; S is chosen from the shape (kernels/knn_exact.py::
//   launch_geometry) so that the blocks fill the SMs: 2 at the repair's
//   8 x 256 queries, 1 where the queries alone fill the card (a
//   self-kNN). The slices' lists meet in shared memory (write_out).
// * Other shapes (knn_exact_kernel: C >= 16, the parity and packed
//   wrappers' flat fallbacks, and clouds too large for shared memory, the
//   capped kNN's fallback past 15 index bits) keep the first design, a
//   warp a query reading rows from L1 / L2, with the same walk.

// An optional device predicate `pred` (int32, may be null): when it reads
// 0 every block returns at once (see knn_banded.cu).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "knn_common.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 4;       // knn_exact_kernel: warps (queries) a block
constexpr int kCloudWarps = 32;  // knn_exact_kernel_cloud: warps a block
constexpr int kMaxSlots = 2;    // k <= 64
constexpr size_t kSmemLimit = 232448;  // shared memory a Hopper block may take
constexpr unsigned kFull = 0xffffffffu;

// (score, row) ranks before (other_score, other_row): larger score first,
// then the lower row
__device__ __forceinline__ bool ahead(float s, int o, float os, int oo) {
  return s > os || (s == os && o < oo);
}

// The warp's list: entries (es[s], ei[s]) at j = s * 32 + lane.
template <int SLOTS>
struct TopList {
  float es[SLOTS];
  int ei[SLOTS];
  float ks;  // the k-th entry, the same in every lane
  int ki;
  int np;  // pending winners (one-slot lists)
};

// One step of a bitonic network across the warp: lanes `lane` and
// `lane ^ j` compare (s, o); the lower lane keeps the one ahead where
// `desc`, the other where not.
__device__ __forceinline__ void bitonic_step(float& s, int& o, int lane, int j, bool desc) {
  const float ps = __shfl_xor_sync(kFull, s, j);
  const int po = __shfl_xor_sync(kFull, o, j);
  const bool lower = (lane & j) == 0;
  const bool partner_ahead = ahead(ps, po, s, o);
  const bool mine_ahead = ahead(s, o, ps, po);
  if (lower == desc ? partner_ahead : mine_ahead) {
    s = ps;
    o = po;
  }
}

// A one-slot list (k <= 32) and up to 32 winners (lane value where `win`)
// merged at once: the winners sorted by a bitonic network, reversed
// against the list, each lane keeps the entry ahead (the 32 best of both,
// as a bitonic sequence), then a bitonic merge: 20 compare-exchange steps
// and the reversal, two shuffles each, where inserting one winner after
// another takes seven shuffles each. The list's first k entries are the k best of the list
// and the winners, as one insertion after another would leave them.
__device__ __forceinline__ void merge_winners(float (&es)[1], int (&ei)[1], float sc, int o,
                                              bool win, int lane) {
  float cs = win ? sc : -INFINITY;
  int ci = win ? o : INT_MAX;
#pragma unroll
  for (int k2 = 2; k2 <= kLanes; k2 <<= 1)
#pragma unroll
    for (int j = k2 >> 1; j > 0; j >>= 1) bitonic_step(cs, ci, lane, j, (lane & k2) == 0);
  const float rs = __shfl_sync(kFull, cs, kLanes - 1 - lane);
  const int ri = __shfl_sync(kFull, ci, kLanes - 1 - lane);
  if (ahead(rs, ri, es[0], ei[0])) {
    es[0] = rs;
    ei[0] = ri;
  }
#pragma unroll
  for (int j = kLanes / 2; j > 0; j >>= 1) bitonic_step(es[0], ei[0], lane, j, true);
}

// A one-slot list's pending winners (`L.np` of them, in the warp's buffer
// `ps` / `pi` of 64): the first min(np, 32) merged into the list at once
// (merge_winners), the rest moved to the buffer's front.
__device__ __forceinline__ void flush_pending(TopList<1>& L, float* ps, int* pi, int lane,
                                              int last_lane) {
  __syncwarp();
  const int n = min(L.np, kLanes), rest = L.np - n;
  const bool has = lane < n;
  merge_winners(L.es, L.ei, has ? ps[lane] : 0.f, has ? pi[lane] : 0, has, lane);
  float rs = 0.f;
  int ri = 0;
  if (lane < rest) {
    rs = ps[kLanes + lane];
    ri = pi[kLanes + lane];
  }
  __syncwarp();
  if (lane < rest) {
    ps[lane] = rs;
    pi[lane] = ri;
  }
  L.np = rest;
  L.ks = __shfl_sync(kFull, L.es[0], last_lane);
  L.ki = __shfl_sync(kFull, L.ei[0], last_lane);
}

// Take the winners of one chunk (lane rows `o`, scores `sc`, in range where
// `valid`): those ahead of the list's k-th entry. With kPending (the cloud
// kernel's one-slot lists, k <= 32) they are appended to the warp's pending
// buffer and merged 32 at a time (flush_pending), the k-th entry rising
// only then: a winner behind the k-th entry of a merge is behind the final
// one too, so the list ends as the k best. Else they are inserted one by
// one, in lane order: the position a popcount of a ballot, the entries
// behind it shifted one lane up.
template <int SLOTS, bool kPending = SLOTS == 1>
__device__ __forceinline__ void insert_chunk(TopList<SLOTS>& L, float sc, int o, bool valid,
                                             int lane, int last_lane, int last_slot, float* ps,
                                             int* pi) {
  unsigned want = __ballot_sync(kFull, valid && ahead(sc, o, L.ks, L.ki));
  if constexpr (kPending) {
    if (want) {
      if ((want >> lane) & 1u) {
        const int at = L.np + __popc(want & ((1u << lane) - 1));
        ps[at] = sc;
        pi[at] = o;
      }
      L.np += __popc(want);
      if (L.np >= kLanes) flush_pending(L, ps, pi, lane, last_lane);
    }
    return;
  }
  while (want) {
    const int src = __ffs(want) - 1;
    want &= want - 1;
    const float cs = __shfl_sync(kFull, sc, src);
    const int ci = __shfl_sync(kFull, o, src);
    if (!ahead(cs, ci, L.ks, L.ki)) continue;  // warp-uniform
    int pos = 0;  // entries ranked before the candidate
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      pos += __popc(__ballot_sync(kFull, ahead(L.es[s], L.ei[s], cs, ci)));
    // entry j = s * 32 + lane takes entry j - 1 for j > pos, the
    // candidate at j == pos; entries beyond slot SLOTS-1 drop off
    float up_s[SLOTS];
    int up_i[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      up_s[s] = __shfl_up_sync(kFull, L.es[s], 1);
      up_i[s] = __shfl_up_sync(kFull, L.ei[s], 1);
    }
#pragma unroll
    for (int s = 1; s < SLOTS; ++s) {
      const float ts = __shfl_sync(kFull, L.es[s - 1], kLanes - 1);
      const int ti = __shfl_sync(kFull, L.ei[s - 1], kLanes - 1);
      if (lane == 0) {
        up_s[s] = ts;
        up_i[s] = ti;
      }
    }
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int j = s * kLanes + lane;
      if (j == pos) {
        L.es[s] = cs;
        L.ei[s] = ci;
      } else if (j > pos) {
        L.es[s] = up_s[s];
        L.ei[s] = up_i[s];
      }
    }
    float ls = L.es[0];
    int li = L.ei[0];
#pragma unroll
    for (int s = 1; s < SLOTS; ++s) {
      if (s == last_slot) {
        ls = L.es[s];
        li = L.ei[s];
      }
    }
    L.ks = __shfl_sync(kFull, ls, last_lane);
    L.ki = __shfl_sync(kFull, li, last_lane);
  }
}

// The list's entries written to `orow` (S == 1), or the S slices' lists of
// a query joined by rank (S > 1): each entry's rank is its position in its
// own list plus, in each other list, the count of entries ahead of it (a
// binary search: the lists are sorted); the entries ranked below K are
// written there. Slices hold disjoint rows, so (score, row) ranks them all;
// empty entries, equal across lists, rank by slice. `m_s` / `m_i` hold one
// list per warp of the block. Every thread of the block calls it (a
// barrier where S > 1).
template <int SLOTS>
__device__ __forceinline__ void write_out(const TopList<SLOTS>& L, int* orow, bool live,
                                          int S, int K, int warp, int lane,
                                          float (*m_s)[kMaxSlots * kLanes],
                                          int (*m_i)[kMaxSlots * kLanes]) {
  if (S == 1) {  // block-uniform
    if (live) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int j = s * kLanes + lane;
        if (j < K) orow[j] = L.ei[s];
      }
    }
    return;
  }
  const int slice = warp % S;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    m_s[warp][s * kLanes + lane] = L.es[s];
    m_i[warp][s * kLanes + lane] = L.ei[s];
  }
  __syncthreads();
  if (!live) return;
  const int first = warp - slice;  // the query's slice 0
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int j = s * kLanes + lane;
    if (j >= K) continue;
    const float cs = L.es[s];
    const int ci = L.ei[s];
    int rank = j;
    for (int o = 0; o < S; ++o) {
      if (o == slice) continue;
      // entries of list o ahead of (cs, ci); an equal one (two empties)
      // is ahead when its slice is lower
      const float* os = m_s[first + o];
      const int* oi = m_i[first + o];
      const bool tie_ahead = o < slice;
      int lo = 0, hi = K;  // entries [0, lo) are ahead, [hi, K) are not
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const float ms = os[mid];
        const int mi = oi[mid];
        if (ahead(ms, mi, cs, ci) || (tie_ahead && ms == cs && mi == ci))
          lo = mid + 1;
        else
          hi = mid;
      }
      rank += lo;
    }
    if (rank < K) orow[rank] = ci;
  }
}

template <int SLOTS>
__device__ __forceinline__ void init_list(TopList<SLOTS>& L) {
  // empty entries (-inf, INT_MAX) rank behind every real row
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    L.es[s] = -INFINITY;
    L.ei[s] = INT_MAX;
  }
  L.ks = -INFINITY;
  L.ki = INT_MAX;
  L.np = 0;
}

// The walk's end: a one-slot list merges its last pending winners.
template <int SLOTS>
__device__ __forceinline__ void finish_list(TopList<SLOTS>& L, float* ps, int* pi, int lane,
                                            int last_lane) {
  if constexpr (SLOTS == 1) {
    if (L.np > 0) flush_pending(L, ps, pi, lane, last_lane);
  }
}

// The chunk a query's walk starts at: its hint's, rows[at] (rows null: with
// own != 0 the query's own row `qq`, a self-kNN's; else row 0).
__device__ __forceinline__ int hint_chunk(const int64_t* rows, long long at, int qq, int own,
                                          int N) {
  long long r = rows != nullptr ? (long long)rows[at] : (own ? qq : 0);
  r = r < 0 ? 0 : (r >= N ? N - 1 : r);
  return (int)r / kLanes;
}

// Clouds the cloud kernel does not take (C >= 16: the parity and packed
// wrappers' flat fallbacks; C <= 8 beyond shared memory: the capped kNN's
// fallback past 15 index bits): the first design's warp per query reading
// rows from L1 / L2, kWarps warps a block, one insertion after another,
// with the walk starting at the hint.
template <int CV, int SLOTS>
__global__ void __launch_bounds__(kLanes * kWarps)
knn_exact_kernel(const float* __restrict__ x,      // (B, N, CV)
                 const float* __restrict__ q,      // (B, M, CV)
                 const float* __restrict__ cnorm,  // (B, N)
                 const int64_t* __restrict__ rows, // (B, M) at row stride rs, or null
                 int* __restrict__ out,            // (B, M, K)
                 const int* __restrict__ pred,     // () or null
                 int N, int M, int K, long long rs) {
  if (pred != nullptr && *pred == 0) return;
  const int lane = threadIdx.x % kLanes;
  const int qq = blockIdx.x * kWarps + threadIdx.x / kLanes;
  const int b = blockIdx.y;
  if (qq >= M) return;  // warp-uniform; the kernel has no block barrier
  TopList<SLOTS> L;
  init_list(L);
  const int last_lane = (K - 1) % kLanes, last_slot = (K - 1) / kLanes;
  float qv[CV];
  load_query<CV>(qv, q + ((size_t)b * M + qq) * CV);
  const float* xb = x + (size_t)b * N * CV;
  const float* cb = cnorm + (size_t)b * N;
  const int nch = (N + kLanes - 1) / kLanes;
  const int c0 = hint_chunk(rows, b * rs + qq, qq, rs != 0, N);
  // the walk: chunks c0, c0 + 1, ..., then c0 - 1, c0 - 2, ...
  for (int t = 0; t < nch; ++t) {
    const int ch = t < nch - c0 ? c0 + t : nch - 1 - t;
    const int o = ch * kLanes + lane;
    const bool valid = o < N;
    const float sc = valid ? knn_score<CV, true>(qv, xb + (size_t)o * CV, cb[o]) : -INFINITY;
    insert_chunk<SLOTS, false>(L, sc, o, valid, lane, last_lane, last_slot, nullptr, nullptr);
  }
  int* orow = out + ((size_t)b * M + qq) * K;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int j = s * kLanes + lane;
    if (j < K) orow[j] = L.ei[s];
  }
}

// The pruning test of the cloud kernel: whether no row whose channel 0
// lies at `x0` or beyond (seen from the query's `q0`) can score ahead of
// the list's k-th entry `ks`. The kernel's score of a row x is within err
// of 2<q, x> - |x|^2 = |q|^2 - |q - x|^2 <= |q|^2 - (q0 - x0)^2, with err
// below 2^-18 (|q|^2 + |x|^2) (the 4- or 8-term FMA dot, the rounded norm,
// the last subtraction: a few units in the last place of those
// magnitudes; `cmax` bounds every row's norm). The test's own float
// roundings (|q|^2 summed by the caller, dx^2, the sum) are a few units in
// the last place of |q|^2 + dx^2 + cmax, and the margin is 2^-14 of that.
// NaN or inf anywhere makes it false: nothing is pruned.
__device__ __forceinline__ bool beyond_reach(float x0, float q0, float qn2, float cmax,
                                             float ks) {
  const float dx = x0 - q0;
  const float d2 = dx * dx;
  return ks > qn2 - d2 + 0x1p-14f * (qn2 + cmax + d2) + 1e-30f;
}

// C <= 8, a cloud that fits a block's shared memory (kernels/knn_exact.py::
// cloud_fits): a block of kCloudWarps warps holds kCloudWarps / S queries of
// one cloud and stages the cloud's rows and norms once by cp.async (7000
// rows of C=4 take 140 KB), so L2 serves each row once a block, not once a
// query. Each warp walks its query's chunks outward from its hint, scoring
// two chunks before it inserts.
//
// Pruning. Where the staged rows are sorted by channel 0 (the repair's
// x-sorted clouds; the block checks it, __syncthreads_and), a row's
// channel-0 distance from the query bounds its score from above
// (beyond_reach): a chunk right of the query's whose first row is already
// out of reach of the list's k-th entry ends the walk on that side (every
// later row there is farther in channel 0), and likewise on the left with
// the chunk's last row. The k-th entry only rises, so a row out of reach
// stays out: the list, and the output, are what the whole walk gives.
template <int CV, int SLOTS>
__global__ void __launch_bounds__(kLanes * kCloudWarps, 1)
knn_exact_kernel_cloud(const float* __restrict__ x,      // (B, N, CV)
                       const float* __restrict__ q,      // (B, M, CV)
                       const float* __restrict__ cnorm,  // (B, N)
                       const int64_t* __restrict__ rows, // (B, M) at row stride rs, or null
                       int* __restrict__ out,            // (B, M, K)
                       const int* __restrict__ pred,     // () or null
                       int N, int M, int K, long long rs, int S) {
  if (pred != nullptr && *pred == 0) return;
  extern __shared__ __align__(16) float csm[];
  float* xs = csm;                      // (N, CV)
  float* ns = csm + (size_t)N * CV;     // (N,)
  __shared__ float m_s[kCloudWarps][kMaxSlots * kLanes];
  __shared__ int m_i[kCloudWarps][kMaxSlots * kLanes];
  __shared__ int cmax_bits;
  __shared__ __align__(8) unsigned long long stage_bar;  // the staging's mbarrier
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int slice = warp % S;
  const int qq = blockIdx.x * (kCloudWarps / S) + warp / S;
  const int b = blockIdx.y;
  const bool live = qq < M;  // warp-uniform
  const float* xb = x + (size_t)b * N * CV;
  const float* cb = cnorm + (size_t)b * N;
  // the cloud by the copy engine: one bulk copy of its rows (16-byte
  // aligned: the wrapper's tensors are, and a cloud is N * CV floats) and,
  // where they start at a 16-byte boundary, one of its norms (else 4
  // bytes a thread, by cp.async); the block waits on an mbarrier
  const bool bulk_norms = ((size_t)b * N) % 4 == 0 && N % 4 == 0;
  const unsigned bar = static_cast<unsigned>(__cvta_generic_to_shared(&stage_bar));
  if (threadIdx.x == 0) {
    cmax_bits = 0;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned xbytes = (unsigned)(sizeof(float) * N * CV);
    const unsigned nbytes = bulk_norms ? (unsigned)(sizeof(float) * N) : 0u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(xbytes + nbytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(xs))), "l"(xb), "r"(xbytes),
        "r"(bar) : "memory");
    if (bulk_norms)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
          ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(ns))), "l"(cb), "r"(nbytes),
          "r"(bar) : "memory");
  }
  if (!bulk_norms)
    for (int i = threadIdx.x; i < N; i += blockDim.x) cp_async4(ns + i, cb + i, true);
  cp_async_commit();
  TopList<SLOTS> L;
  init_list(L);
  const int last_lane = (K - 1) % kLanes, last_slot = (K - 1) / kLanes;
  float qv[CV];
  if (live) load_query<CV>(qv, q + ((size_t)b * M + qq) * CV);
  cp_async_wait<0>();
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar) : "memory");
  __syncthreads();
  // sorted by channel 0 (NaN fails), and the largest norm (as int bits: a
  // non-negative float orders as its bits; NaN orders above inf)
  bool sorted = true;
  int cbits = 0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    if (i + 1 < N) sorted = sorted && xs[(size_t)i * CV] <= xs[(size_t)(i + 1) * CV];
    cbits = max(cbits, __float_as_int(ns[i]));
  }
  for (int o = 16; o > 0; o >>= 1) cbits = max(cbits, __shfl_xor_sync(kFull, cbits, o));
  if (lane == 0) atomicMax(&cmax_bits, cbits);
  sorted = __syncthreads_and(sorted);
  if (live) {
    const float cmax = __int_as_float(cmax_bits);
    float qn2 = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c) qn2 = fmaf(qv[c], qv[c], qn2);
    const int nch = (N + kLanes - 1) / kLanes;
    const int c0 = hint_chunk(rows, b * rs + qq, qq, rs != 0, N);
    // the right side (chunks c0, c0 + 1, ...), then the left (c0 - 1,
    // c0 - 2, ...); slice s takes the walk's steps s, s + S, ...
    const int nr = nch - c0;
    for (int t = slice; t < nr; t += S) {
      const int ch = c0 + t;
      if (t > 0 && sorted && xs[(size_t)ch * kLanes * CV] >= qv[0] &&
          beyond_reach(xs[(size_t)ch * kLanes * CV], qv[0], qn2, cmax, L.ks))
        break;
      const int o = ch * kLanes + lane;
      const bool valid = o < N;
      const float sc = valid ? knn_score<CV, false>(qv, xs + (size_t)o * CV, ns[o]) : -INFINITY;
      insert_chunk<SLOTS>(L, sc, o, valid, lane, last_lane, last_slot, m_s[warp], m_i[warp]);
    }
    for (int t = nr + ((slice - nr) % S + S) % S; t < nch; t += S) {
      const int ch = nch - 1 - t;
      const float xl = xs[(size_t)(ch * kLanes + kLanes - 1) * CV];
      if (sorted && xl <= qv[0] && beyond_reach(xl, qv[0], qn2, cmax, L.ks)) break;
      const int o = ch * kLanes + lane;
      const bool valid = o < N;
      const float sc = valid ? knn_score<CV, false>(qv, xs + (size_t)o * CV, ns[o]) : -INFINITY;
      insert_chunk<SLOTS>(L, sc, o, valid, lane, last_lane, last_slot, m_s[warp], m_i[warp]);
    }
    finish_list<SLOTS>(L, m_s[warp], m_i[warp], lane, last_lane);
  }
  write_out<SLOTS>(L, out + ((size_t)b * M + qq) * K, live, S, K, warp, lane, m_s, m_i);
}

// The rows of a cloud the cloud kernel stages: its rows, norms and the
// slices' lists must fit a block's shared memory.
template <int CV>
bool cloud_fits(int N) {
  constexpr size_t lists = 2 * sizeof(float) * kCloudWarps * kMaxSlots * kLanes + 16;
  return sizeof(float) * (size_t)N * (CV + 1) + lists <= kSmemLimit;
}

template <int CV, int SLOTS>
cudaError_t launch(const float* x, const float* q, const float* cnorm, const int64_t* rows,
                   int* out, const int* pred, int B, int N, int M, int K, long long rs, int S,
                   cudaStream_t stream) {
  if constexpr (CV <= 8) {
    if (cloud_fits<CV>(N)) {
      const size_t smem = sizeof(float) * (size_t)N * (CV + 1);
      cudaError_t err = cudaFuncSetAttribute(knn_exact_kernel_cloud<CV, SLOTS>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
      if (err != cudaSuccess) return err;
      const int qb = kCloudWarps / S;
      const dim3 grid((M + qb - 1) / qb, B);
      knn_exact_kernel_cloud<CV, SLOTS><<<grid, kLanes * kCloudWarps, smem, stream>>>(
          x, q, cnorm, rows, out, pred, N, M, K, rs, S);
      return cudaGetLastError();
    }
  }
  if (S != 1) return cudaErrorInvalidValue;  // one warp a query
  const dim3 grid((M + kWarps - 1) / kWarps, B);
  knn_exact_kernel<CV, SLOTS><<<grid, kLanes * kWarps, 0, stream>>>(
      x, q, cnorm, rows, out, pred, N, M, K, rs);
  return cudaGetLastError();
}

template <int SLOTS>
cudaError_t launch_cv(int cv, const float* x, const float* q, const float* cnorm,
                      const int64_t* rows, int* out, const int* pred, int B, int N, int M,
                      int K, long long rs, int S, cudaStream_t s) {
  switch (cv) {
    case 4: return launch<4, SLOTS>(x, q, cnorm, rows, out, pred, B, N, M, K, rs, S, s);
    case 8: return launch<8, SLOTS>(x, q, cnorm, rows, out, pred, B, N, M, K, rs, S, s);
    case 16: return launch<16, SLOTS>(x, q, cnorm, rows, out, pred, B, N, M, K, rs, S, s);
    case 32: return launch<32, SLOTS>(x, q, cnorm, rows, out, pred, B, N, M, K, rs, S, s);
    case 64: return launch<64, SLOTS>(x, q, cnorm, rows, out, pred, B, N, M, K, rs, S, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B,N,cv), q (B,M,cv) with cv in {4,8,16,32,64} (zero-padded channels);
// cnorm (B,N); rows (B,M) int64 at a batch stride of rows_stride elements,
// each query's row in an x-sorted cloud (where its walk starts), or null:
// then rows_stride 1 starts each query at its own row (a self-kNN: query m
// is row m), 0 at row 0 (ascending); out (B,M,K) int32 with 1 <= K <= 64;
// pred a device int32 or null; slices in {1, 2, 4, 8} warps per query (the
// cloud kernel; 1 for knn_exact_kernel). Returns a cudaError_t.
extern "C" int dgcnn_knn_exact(const float* x, const float* q, const float* cnorm,
                               const int64_t* rows, int* out, const int* pred, int B, int N,
                               int M, int cv, int K, int rows_stride, int slices,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > kMaxSlots * kLanes) return cudaErrorInvalidValue;
  if (slices != 1 && slices != 2 && slices != 4 && slices != 8) return cudaErrorInvalidValue;
  if (M == 0 || B == 0) return cudaSuccess;
  if (K <= kLanes)
    return launch_cv<1>(cv, x, q, cnorm, rows, out, pred, B, N, M, K, rows_stride, slices, s);
  return launch_cv<2>(cv, x, q, cnorm, rows, out, pred, B, N, M, K, rows_stride, slices, s);
}
