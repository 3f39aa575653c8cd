// Approximate k-nearest-neighbour selection for Hopper (sm_90a):
// knn_impl="approx".
//
// Replaces XLA's ApproxTopK, which dgcnn_tpu/ops/knn.py::knn(approx=True)
// reaches through jax.lax.approx_max_k(scores, k, recall_target) (no
// pl.pallas_call: on a TPU it lowers to the PartialReduce). It computes
// what ops/knn.py::knn(approx=True) computes:
//
//   score(q, o) = 2 * <q, x_o> - |x_o|^2              (FP32, FMA dot;
//                                                       knn_common.cuh)
//   bin(o)      = o mod L, L = approx_reduction_size(N, k, recall_target)
//   winner(b)   = the largest score of bin b, ties to the LOWER row
//   output      = the k best winners, larger score first, ties to the
//                 LOWER row
//
// Where L = N every row is its own bin and the output is the exact kNN's
// (knn_exact.cu's, bit for bit: the same score bits, the same order).
// Non-finite scores: a bin's winner is its chunk-0 score unless a later
// chunk's is strictly greater (a NaN at chunk 0 keeps the bin, a later NaN
// never wins); a NaN winner never enters the output, a -inf winner ranks
// ahead of the empty slots, which read INT_MAX.
//
// What bounds it on the H100: 2 * N * C FP32 operations a query (0.749 ms
// at B=8, N=7000, C=64 over 67 TFLOP/s; 0.047 ms at C=4), then the
// selection: each of the ~k (1 + ln(L / k)) winners that beat a query's
// running k-th (~124 a query at L = 896, k = 30) goes into its list.
//
// Design. The bins come in groups of 32, one a lane or thread column; a
// group's chunks in stages of up to 8, so that a stage holds 256
// positions: position c * 32 + j is bin 32 g + j's chunk 8 s + c (row
// 32 g + j + (8 s + c) * L), zero-filled where the bin is >= L, the chunk
// >= T = ceil(N / L) or the row >= N. Stages are staged by cp.async,
// double-buffered, one barrier a stage. The groups are walked outward from
// the group of the block's middle query (g0, g0 + 1, g0 - 1, ... mod the
// group count; in an x-sorted cloud a query's near rows sit in the bins
// near its own row's), each group's stages in turn; a query's running
// winner of each bin is carried from one stage to the next in registers
// and folded chunk by chunk (chunk 0 first, a later chunk replaces it only
// when strictly greater). Neither the order nor the split changes an
// output: the lists are exact.
//
// Each query's top-KMAX (KMAX >= k) lies across its warp's lanes, slot s
// in lane s % 32, as 64-bit keys: high word score_key(winner) (the
// order-exact int32 of the score; +0 and -0 alike), low word ~row, so
// that the key order is (score descending, row ascending) exactly; a NaN
// winner, a bin >= L and an empty slot are LLONG_MIN, below every real
// key (a -inf winner's high word is above INT_MIN). After a group, a
// warp's 8 queries take their 32 winners, one a lane: one ballot a query
// keeps those above its k-th key so far (exact: the running k-th only
// rises). A query with more than kNetwork survivors (6; 10 in the
// two-phase kernel; the first groups of the walk pass nearly all 32) takes
// them at once: a bitonic network sorts them across the warp and a bitonic
// merge keeps the 32 largest of them and the list (64-bit keys: the
// 32-slot lists only); the rest go in one at a time, by a ballot of the slots
// above each (its position), a shuffle that moves the slots below it down
// one lane and a select (knn_packed.cu's list_insert, on 64-bit keys).
// Either way a list ends as the KMAX largest keys it was given, so the
// output does not depend on which way a key went in. The selection no
// longer runs in every lane for one lane's sake (the first design ran a
// 32-slot insertion at nearly every bin, since some lane of the warp
// needed it).
//
// * C >= 16, two phases: 256 threads, 64 queries a block, 8 a warp.
//   Phase A: each thread computes the 8 x 8 dots of 8 queries and the 8
//   chunks of one bin (knn_select.cuh's tile_dots: two channels a read,
//   every float from shared memory feeding 4 FMAs, each dot one fmaf
//   chain), folds the chunks in registers and, after the group's last
//   stage, writes its 8 winners' keys into the group's 64 x 32 winner
//   tile (two tiles, alternating). Phase B: the warps' selection from the
//   last group's tile, after the next stage's phase A and before the next
//   barrier, while the next stage's copy is in flight. With two warps a
//   scheduler the selection is latency-bound: the insertions go in rounds
//   of one survivor for each of the 8 queries, branch-free, and where any
//   query takes the network all 8 do, so that the queries' chains overlap.
//   One block of 8 warps an SM (199,680 bytes of shared memory at C=64).
// * C <= 8, fused: the dot is a few FMAs, so a warp keeps its 8 queries in
//   registers and each lane scores its bin's chunks for them, folds them
//   and offers one winner a query to the same ballot and insertion; two
//   blocks an SM, so the selection is throughput-bound and a query's
//   survivors go in query by query (no empty insertion, no network for a
//   query that does not need it).
//
// Where T < 8 the two-phase kernel still computes 8 chunks a stage (the
// rest are zero rows, masked); the fused one skips them.
//
// Measured on the H100 (700 W, the approx forward's calls, B=8 N=7000
// k=30): 0.497 ms at C=4 (9.4% of the bound; 0.259 without insertions),
// 1.87-1.88 ms at C=64 (40%; 1.57 without insertions). What is left: at
// C=64 the dot loop at one block of 8 warps an SM, at C=4 the scoring
// loop's issue and the selection's integer work.
//
// Resources (nvcc -Xptxas -v, sm_90a; the build log beside the library):
// the two-phase C=64 KMAX-32 instance 218 registers, the fused C=4 KMAX-32
// instance 120 (bounded to two blocks an SM), no spill in any instance;
// 199,680 / 10,240 bytes of shared memory.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "knn_common.cuh"  // score_key, load_query, cp.async helpers
#include "knn_select.cuh"  // row_stride4, stage_queries, tile_dots

namespace {

constexpr int kThreads = 256;  // a block: 8 warps ...
constexpr int kQW = 8;         // ... of 8 queries each
constexpr int kQB = kThreads / 32 * kQW;
constexpr int kGroup = 32;                     // bins a group, one a lane
constexpr int kChunks = 8;                     // chunks a stage
constexpr int kStageRows = kGroup * kChunks;   // positions a stage
constexpr int kWinStride = 40;  // the winner tile's row in keys: phase A's
                                // 8-byte stores conflict-free
constexpr long long kEmpty = LLONG_MIN;

// (score, row) as a 64-bit key: (score desc, row asc) is the key's order;
// a NaN score is kEmpty (never enters).
__device__ __forceinline__ long long winner_key(float s, int row) {
  if (s != s) return kEmpty;
  return (long long)(((unsigned long long)(unsigned)score_key(s) << 32) | (unsigned)~row);
}

__device__ __forceinline__ int key_row(long long key) {
  return key == kEmpty ? INT_MAX : ~(int)(unsigned)key;
}

// The i-th group of the walk from group g0: g0, g0 + 1, g0 - 1, g0 + 2,
// ... mod G (G consecutive offsets: each group once).
__device__ __forceinline__ int walk_group(int i, int g0, int G) {
  const int off = (i & 1) ? (i + 1) / 2 : -(i / 2);
  return ((g0 + off) % G + G) % G;
}

// The row at position p of stage s of group g, or -1 (a bin >= L, a chunk
// >= T, a row >= N).
__device__ __forceinline__ int stage_row(int g, int s, int p, int L, int T, int N) {
  const int bin = g * kGroup + (p & (kGroup - 1)), t = s * kChunks + p / kGroup;
  const int o = bin + t * L;
  return bin < L && t < T && o < N ? o : -1;
}

// Stage s of group g: its rows' CV channels into rows of stride
// row_stride4 and their norms, by cp.async, zero-filled where there is no
// row; then commits.
template <int CV>
__device__ __forceinline__ void stage_rows(float4* xs4, float* xn, const float* xb,
                                           const float* cb, int g, int s, int L, int T,
                                           int N) {
  constexpr int V = CV / 4, XS4 = row_stride4<CV>();
  for (int e = threadIdx.x; e < kStageRows * V; e += blockDim.x) {
    const int p = e / V, c4 = e - p * V;
    const int o = stage_row(g, s, p, L, T, N);
    cp_async16(xs4 + p * XS4 + c4, xb + (o >= 0 ? (size_t)o * CV + 4 * c4 : 0), o >= 0);
  }
  for (int p = threadIdx.x; p < kStageRows; p += blockDim.x) {
    const int o = stage_row(g, s, p, L, T, N);
    cp_async4(xn + p, cb + (o >= 0 ? o : 0), o >= 0);
  }
  cp_async_commit();
}

// Chunk t's score (row o, or -1) into the running winner (best, brow) of
// its bin: chunk 0 sets it, a later chunk replaces it when strictly greater.
__device__ __forceinline__ void fold(float& best, int& brow, float sc, int o, bool first) {
  if (first) {
    best = sc;
    brow = o;
  } else if (o >= 0 && sc > best) {
    best = sc;
    brow = o;
  }
}

// A warp's sorted list of 32 * LW unique keys, largest first, slot s in
// lane s % 32, register s / 32.
template <int LW>
__device__ __forceinline__ long long list_slot(const long long (&lst)[LW], int slot) {
  const long long v = LW == 1 || slot < 32 ? lst[0] : lst[LW - 1];
  return __shfl_sync(0xffffffffu, v, slot & 31);
}

// c into the warp's list (real keys unique): its position is the number of
// slots above it; the slots from there on move down one (the last drops).
template <int LW>
__device__ __forceinline__ void list_insert(long long (&lst)[LW], long long c, int lane) {
  int pos = 0;
#pragma unroll
  for (int l = 0; l < LW; ++l) pos += __popc(__ballot_sync(0xffffffffu, lst[l] > c));
  long long carry = 0;  // the slot above lane 0 of register l: lane 31 of register l - 1
#pragma unroll
  for (int l = 0; l < LW; ++l) {
    const long long up = __shfl_up_sync(0xffffffffu, lst[l], 1);
    const int slot = lane + 32 * l;
    // lane 0 of register 0 is at or above the position: never moved
    const long long moved = l > 0 && lane == 0 ? carry : up;
    if (l + 1 < LW) carry = __shfl_sync(0xffffffffu, lst[l], 31);
    lst[l] = slot < pos ? lst[l] : (slot == pos ? c : moved);
  }
}

// The larger (max) or smaller of two keys.
__device__ __forceinline__ long long pick(long long a, long long b, bool larger) {
  return (a > b) == larger ? a : b;
}

// A key a lane, sorted across the warp, largest first (a bitonic network:
// 15 compare-exchange steps).
__device__ __forceinline__ long long warp_sort(long long v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const long long other = __shfl_xor_sync(0xffffffffu, v, stride);
      // runs of `size` alternate largest-first and smallest-first; the
      // lower lane of a pair keeps the run's leading key
      v = pick(v, other, ((lane & stride) == 0) == ((lane & size) == 0));
    }
  }
  return v;
}

// The 32 largest of a sorted list (a key a lane, largest first) and 32
// sorted candidates, sorted: the candidates reversed against the list
// give, slot by slot, the larger of each pair a bitonic sequence that
// holds the 32 largest; 5 merge steps sort it.
__device__ __forceinline__ long long warp_merge(long long lst, long long cand, int lane) {
  long long v = pick(lst, __shfl_sync(0xffffffffu, cand, 31 - lane), true);
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    v = pick(v, __shfl_xor_sync(0xffffffffu, v, stride), (lane & stride) == 0);
  return v;
}

// The survivors `pass` of one group (a winner a lane, `v`) of each of the
// warp's queries into their lists (a survivor that has fallen below the
// k-th key since its ballot lands past slot k - 1, which is never read, or
// past the list: KMAX >= k); then each query's k-th key, read once. Each
// list ends as the KMAX largest of its keys and its survivors, however
// they go in: a query of more than kNetwork survivors (a 32-slot list)
// takes them all at once, sorted by a network and merged; the rest go in
// one at a time. kRounds (the two-phase kernel, two warps a scheduler:
// latency-bound): in rounds of one survivor a query, branch-free (a query
// with none left inserts kEmpty, which changes nothing), so that the
// queries' insertions overlap, and all 8 queries through the network where
// one needs it; else (the fused kernel, whose SM holds more warps:
// throughput-bound) query by query, no insertion wasted.
constexpr int kNetworkRounds = 10, kNetwork = 6;

template <int LW, bool kRounds>
__device__ __forceinline__ void insert_batch(long long (&lst)[kQW][LW], long long (&kth)[kQW],
                                             const long long (&v)[kQW], unsigned (&pass)[kQW],
                                             int lane, int K) {
  if constexpr (LW == 1) {
    bool big = false;
#pragma unroll
    for (int qi = 0; qi < kQW; ++qi) big |= __popc(pass[qi]) > kNetworkRounds;
#pragma unroll
    for (int qi = 0; qi < kQW; ++qi) {
      if (kRounds ? big : __popc(pass[qi]) > kNetwork) {  // warp-uniform
        const long long c = (pass[qi] >> lane) & 1 ? v[qi] : kEmpty;
        lst[qi][0] = warp_merge(lst[qi][0], warp_sort(c, lane), lane);
        pass[qi] = 0;
      }
    }
  }
  if constexpr (kRounds) {
    unsigned any = 0;
#pragma unroll
    for (int qi = 0; qi < kQW; ++qi) any |= pass[qi];
    while (any) {  // warp-uniform
      any = 0;
#pragma unroll
      for (int qi = 0; qi < kQW; ++qi) {
        const long long c = __shfl_sync(0xffffffffu, v[qi], (__ffs(pass[qi]) - 1) & 31);
        list_insert<LW>(lst[qi], pass[qi] ? c : kEmpty, lane);
        pass[qi] &= pass[qi] - 1;
        any |= pass[qi];
      }
    }
  } else {
#pragma unroll
    for (int qi = 0; qi < kQW; ++qi)
      for (; pass[qi]; pass[qi] &= pass[qi] - 1)  // warp-uniform
        list_insert<LW>(lst[qi], __shfl_sync(0xffffffffu, v[qi], __ffs(pass[qi]) - 1), lane);
  }
#pragma unroll
  for (int qi = 0; qi < kQW; ++qi) kth[qi] = list_slot<LW>(lst[qi], K - 1);
}

// One group's winners (a lane's `v`, one a query) against the warp's lists:
// a ballot keeps those above each query's k-th key so far (exact: the
// running k-th only rises).
template <int LW, bool kRounds>
__device__ __forceinline__ void offer(long long (&lst)[kQW][LW], long long (&kth)[kQW],
                                      const long long (&v)[kQW], int lane, int K) {
  unsigned pass[kQW], any = 0;
#pragma unroll
  for (int qi = 0; qi < kQW; ++qi) {
    pass[qi] = __ballot_sync(0xffffffffu, v[qi] > kth[qi]);
    any |= pass[qi];
  }
  if (any) insert_batch<LW, kRounds>(lst, kth, v, pass, lane, K);  // warp-uniform
}

// Phase B of the two-phase kernel: the warp's queries take their 32
// winners of one group (a lane each) from a winner tile [kQB][kWinStride].
template <int LW>
__device__ __forceinline__ void select_from(const long long* tile, long long (&lst)[kQW][LW],
                                            long long (&kth)[kQW], int warp, int lane, int K) {
  long long v[kQW];
#pragma unroll
  for (int qi = 0; qi < kQW; ++qi) v[qi] = tile[(warp * kQW + qi) * kWinStride + lane];
  offer<LW, true>(lst, kth, v, lane, K);
}

// Each lane's slots of the warp's queries' top-k (queries qw0 + qi) as
// rows; queries past M skipped.
template <int LW>
__device__ __forceinline__ void write_lists(const long long (&lst)[kQW][LW],
                                            int* __restrict__ out, int b, int M, int K,
                                            int qw0, int lane) {
#pragma unroll
  for (int qi = 0; qi < kQW; ++qi) {
#pragma unroll
    for (int l = 0; l < LW; ++l) {
      const int slot = lane + 32 * l;
      if (qw0 + qi < M && slot < K)
        out[((size_t)b * M + qw0 + qi) * K + slot] = key_row(lst[qi][l]);
    }
  }
}

template <int LW>
__device__ __forceinline__ void init_lists(long long (&lst)[kQW][LW], long long (&kth)[kQW]) {
#pragma unroll
  for (int qi = 0; qi < kQW; ++qi) {
    kth[qi] = kEmpty;
#pragma unroll
    for (int l = 0; l < LW; ++l) lst[qi][l] = kEmpty;
  }
}

// The walk's shape: chunks T, groups G, stages a group S, the first group.
struct Walk {
  int T, G, S, g0;
  __device__ Walk(int N, int L, int q0) {
    T = (N + L - 1) / L;
    G = (L + kGroup - 1) / kGroup;
    S = (T + kChunks - 1) / kChunks;
    g0 = ((q0 + kQB / 2) % L) / kGroup;
  }
};

// The two-phase kernel (C >= 16).
template <int CV, int KMAX>
__global__ void __launch_bounds__(kThreads, 1)
knn_approx_tiled_kernel(const float* __restrict__ x,      // (B, N, CV)
                        const float* __restrict__ q,      // (B, M, CV)
                        const float* __restrict__ cnorm,  // (B, N)
                        int* __restrict__ out,            // (B, M, K)
                        int N, int M, int K, int L) {
  constexpr int XS4 = row_stride4<CV>();
  constexpr int TY = kQB / 8, TX = kThreads / TY, LW = KMAX / 32;
  static_assert(TX == kGroup, "a thread column is a bin");
  extern __shared__ float4 smem4[];
  // [queries kQB x XS4] [2 stages x kStageRows x XS4] [2 x kStageRows norms]
  // [2 winner tiles x kQB x kWinStride]
  float4* qs4 = smem4;
  float4* xs4 = qs4 + kQB * XS4;
  float* xn = reinterpret_cast<float*>(xs4 + 2 * kStageRows * XS4);
  long long* wt = reinterpret_cast<long long*>(xn + 2 * kStageRows);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // phase A: a warp is 4 query rows by 8 consecutive bins
  const int tx = (warp % (TX / 8)) * 8 + (lane & 7);
  const int ty = (warp / (TX / 8)) * 4 + (lane >> 3);
  const int b = blockIdx.y, q0 = blockIdx.x * kQB;
  const Walk w(N, L, q0);
  const int stages = w.G * w.S;
  const float* xb = x + (size_t)b * N * CV;
  const float* cb = cnorm + (size_t)b * N;

  stage_queries<CV>(qs4, q + (size_t)b * M * CV, q0, kQB, M);  // committed with stage 0
  stage_rows<CV>(xs4, xn, xb, cb, walk_group(0, w.g0, w.G), 0, L, w.T, N);
  long long lst[kQW][LW], kth[kQW];  // the warp's queries' lists; their k-th keys so far
  init_lists<LW>(lst, kth);
  float best[8];  // queries ty + TY * a: the running winner of bin tx
  int brow[8];
  int pending = -1;  // the winner tile whose group phase B has not taken yet

  for (int i = 0; i < stages; ++i) {
    const int g = walk_group(i / w.S, w.g0, w.G), s = i % w.S, buf = i & 1;
    cp_async_wait<0>();
    __syncthreads();  // stage i has arrived; every thread is done with stage i - 1
    if (i + 1 < stages)
      stage_rows<CV>(xs4 + (buf ^ 1) * kStageRows * XS4, xn + (buf ^ 1) * kStageRows, xb, cb,
                     walk_group((i + 1) / w.S, w.g0, w.G), (i + 1) % w.S, L, w.T, N);
    const float4* xt = xs4 + buf * kStageRows * XS4;
    const float* nt = xn + buf * kStageRows;
    float acc[8][8];
    tile_dots<CV, TX>(acc, qs4, xt, ty, TY, tx);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int o = stage_row(g, s, c * kGroup + tx, L, w.T, N);
      const float nv = nt[c * kGroup + tx];
#pragma unroll
      for (int a = 0; a < 8; ++a)
        fold(best[a], brow[a], __fsub_rn(__fmul_rn(2.f, acc[a][c]), nv), o, s == 0 && c == 0);
    }
    // phase B of the last group (its winners were written before this
    // stage's barrier), no barrier between it and this stage's phase A
    if (pending >= 0) select_from<LW>(wt + pending * kQB * kWinStride, lst, kth, warp, lane, K);
    pending = -1;
    if (s == w.S - 1) {  // the group's winners are final: into the group's tile
      const bool real = g * kGroup + tx < L;
      const int wb = (i / w.S) & 1;
#pragma unroll
      for (int a = 0; a < 8; ++a)
        wt[wb * kQB * kWinStride + (ty + TY * a) * kWinStride + tx] =
            real ? winner_key(best[a], brow[a]) : kEmpty;
      pending = wb;
    }
  }
  __syncthreads();
  select_from<LW>(wt + pending * kQB * kWinStride, lst, kth, warp, lane, K);
  write_lists<LW>(lst, out, b, M, K, q0 + warp * kQW, lane);
}

// The fused kernel (C <= 8): a warp's 8 queries in registers, a lane a bin.
template <int CV, int KMAX>
__global__ void __launch_bounds__(kThreads, KMAX == 32 && CV == 4 ? 2 : 1)
knn_approx_fused_kernel(const float* __restrict__ x,      // (B, N, CV)
                        const float* __restrict__ q,      // (B, M, CV)
                        const float* __restrict__ cnorm,  // (B, N)
                        int* __restrict__ out,            // (B, M, K)
                        int N, int M, int K, int L) {
  constexpr int XS4 = row_stride4<CV>(), V = CV / 4, LW = KMAX / 32;
  extern __shared__ float4 smem4[];
  float4* xs4 = smem4;                                              // [2][kStageRows][XS4]
  float* xn = reinterpret_cast<float*>(xs4 + 2 * kStageRows * XS4);  // [2][kStageRows]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * kQB;
  const Walk w(N, L, q0);
  const int stages = w.G * w.S;
  const float* xb = x + (size_t)b * N * CV;
  const float* cb = cnorm + (size_t)b * N;

  stage_rows<CV>(xs4, xn, xb, cb, walk_group(0, w.g0, w.G), 0, L, w.T, N);
  float qv[kQW][CV];
#pragma unroll
  for (int qi = 0; qi < kQW; ++qi)
    load_query<CV>(qv[qi], q + ((size_t)b * M + min(q0 + warp * kQW + qi, M - 1)) * CV);
  long long lst[kQW][LW], kth[kQW];
  init_lists<LW>(lst, kth);
  float best[kQW];  // the running winner of the lane's bin, a query
  int brow[kQW];

  for (int i = 0; i < stages; ++i) {
    const int g = walk_group(i / w.S, w.g0, w.G), s = i % w.S, buf = i & 1;
    cp_async_wait<0>();
    __syncthreads();  // stage i has arrived; every warp is done with stage i - 1
    if (i + 1 < stages)
      stage_rows<CV>(xs4 + (buf ^ 1) * kStageRows * XS4, xn + (buf ^ 1) * kStageRows, xb, cb,
                     walk_group((i + 1) / w.S, w.g0, w.G), (i + 1) % w.S, L, w.T, N);
    const float4* xt = xs4 + buf * kStageRows * XS4;
    const float* nt = xn + buf * kStageRows;
    const int chunks = min(kChunks, w.T - s * kChunks);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c >= chunks) break;
      const int p = c * kGroup + lane;
      const int o = stage_row(g, s, p, L, w.T, N);
      float xr[CV];
#pragma unroll
      for (int c4 = 0; c4 < V; ++c4) {
        const float4 f = xt[p * XS4 + c4];
        xr[4 * c4] = f.x;
        xr[4 * c4 + 1] = f.y;
        xr[4 * c4 + 2] = f.z;
        xr[4 * c4 + 3] = f.w;
      }
      const float nv = nt[p];
#pragma unroll
      for (int qi = 0; qi < kQW; ++qi) {
        float dot = 0.f;
#pragma unroll
        for (int ch = 0; ch < CV; ++ch) dot = fmaf(qv[qi][ch], xr[ch], dot);
        fold(best[qi], brow[qi], __fsub_rn(__fmul_rn(2.f, dot), nv), o, s == 0 && c == 0);
      }
    }
    if (s == w.S - 1) {  // the group's winners are final
      const bool real = g * kGroup + lane < L;
      long long v[kQW];
#pragma unroll
      for (int qi = 0; qi < kQW; ++qi) v[qi] = real ? winner_key(best[qi], brow[qi]) : kEmpty;
      offer<LW, false>(lst, kth, v, lane, K);
    }
  }
  write_lists<LW>(lst, out, b, M, K, q0 + warp * kQW, lane);
}

// Shared memory (bytes): two stages and their norms; at C >= 16 also the
// queries and the two winner tiles.
size_t smem_bytes(int cv) {
  const size_t xs4 = (cv / 4) % 2 ? cv / 4 : cv / 4 + 1;
  const size_t stages = 2 * (size_t)kStageRows * (16 * xs4 + 4);
  if (cv <= 8) return stages;
  return 16 * (size_t)kQB * xs4 + stages + 16 * (size_t)kQB * kWinStride;
}

template <int CV, int KMAX>
cudaError_t launch(const float* x, const float* q, const float* cnorm, int* out, int B, int N,
                   int M, int K, int L, cudaStream_t stream) {
  const size_t smem = smem_bytes(CV);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)limit) return cudaErrorInvalidValue;
  void (*kernel)(const float*, const float*, const float*, int*, int, int, int, int);
  if constexpr (CV <= 8) {
    kernel = knn_approx_fused_kernel<CV, KMAX>;
  } else {
    kernel = knn_approx_tiled_kernel<CV, KMAX>;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kQB - 1) / kQB, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, q, cnorm, out, N, M, K, L);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t launch_cv(int cv, const float* x, const float* q, const float* cnorm, int* out,
                      int B, int N, int M, int K, int L, cudaStream_t s) {
  switch (cv) {
    case 4: return launch<4, KMAX>(x, q, cnorm, out, B, N, M, K, L, s);
    case 8: return launch<8, KMAX>(x, q, cnorm, out, B, N, M, K, L, s);
    case 16: return launch<16, KMAX>(x, q, cnorm, out, B, N, M, K, L, s);
    case 32: return launch<32, KMAX>(x, q, cnorm, out, B, N, M, K, L, s);
    case 64: return launch<64, KMAX>(x, q, cnorm, out, B, N, M, K, L, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B,N,cv), q (B,M,cv) with cv in {4,8,16,32,64} (zero-padded channels),
// 16-byte aligned; cnorm (B,N); out (B,M,K) int32 with 1 <= K <= 64 and
// K <= L <= N, L the bins (kernels/knn_approx.py: ops/knn.py::
// approx_reduction_size). Returns a cudaError_t.
extern "C" int dgcnn_knn_approx(const float* x, const float* q, const float* cnorm, int* out,
                                int B, int N, int M, int cv, int K, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > 64 || L < K || L > N) return cudaErrorInvalidValue;
  if (M == 0 || B == 0) return cudaSuccess;
  if (K <= 32) return launch_cv<32>(cv, x, q, cnorm, out, B, N, M, K, L, s);
  return launch_cv<64>(cv, x, q, cnorm, out, B, N, M, K, L, s);
}
