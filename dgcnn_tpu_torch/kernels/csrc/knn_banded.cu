// Banded capped packed-key k-nearest-neighbour selection for Hopper (sm_90a).
//
// Replaces dgcnn_tpu/kernels/knn_pallas.py::_knn_kernel_banded (launched
// from _knn_banded_jit). Self-kNN over x-sorted rows: query tile t (qt
// queries) scores only the `band` rows [start, start + band), start being
// _band_starts' 128-aligned row for the tile. It computes exactly what the
// TPU kernel computes:
//
//   score(q, o) = (2 * <x_o, q> - |x_o|^2) - |q|^2      (FP32, FMA dot)
//   key         = monotone_int(score) >> 1, low idx_bits replaced by
//                 (band - 1 - r), r = o - start         (unique per query)
//   per window w = { r : r % n_win == w } keep the top-`cap` keys,
//   then merge the n_win * cap winners to the top-k, largest key first;
//   the k-th winner's packed key is written beside the indices.
//
// Rows o >= N (the TPU kernel's padding up to a multiple of 128) score
// -inf. A window with fewer than `cap` rows keeps what it has: the TPU
// kernel's extraction cycles back to that window's largest key there,
// which the merge skips as a repeat, so each row counts once either way.
//
// What bounds it on the H100: B*N*band*C FP32 FMAs (14.7 G at B=8, N=7000,
// band 4096, C=64; 0.46 G at band 2048, C=4), plus per pair the score's
// two subtractions, the key and the insertion into the window's list
// (integer min/max, which the SM issues at half the FMA rate): at C=4 the
// selection, not the dot, is most of the work.
//
// Bit-equality. Every dot is one fmaf chain over channels 0..CV-1 from
// 0.f, then the two explicitly rounded subtractions; the keys are unique
// within a band (their low bits), so the per-window top-cap and the merge
// are functions of the keys alone, whatever order the rows are scored in.
// Any kernel that keeps those two rules returns the same indices and k-th
// keys bit for bit on every input, floats included: this one returns those
// of the kernel it replaced (one query per lane). No tensor-core work:
// TF32 would flip rankings (the port's FP32 policy), and 3xTF32 sums in
// another order, so its keys would no longer be bit-equal to the plain
// version's or to the replaced kernel's, and the wrapper's certificate
// compares the k-th key with the band-edge bound.
//
// Design. A block owns 64 or 32 queries that share one band start (they
// divide the query tile) and walks the band in rounds of 64 windows (one
// round when n_win <= 64). Window w is the residue class r % n_win, so a
// j-step (the rows j * n_win + w0 + s, s < 64) holds one candidate of each
// of the round's windows. Tiles of j-steps arrive by cp.async (16 bytes a
// thread, zero-filled past N) into rows of an odd float4 stride, so the 8
// consecutive rows a warp reads fall in 8 bank groups. Each (query,
// window) pair keeps its sorted top-cap keys in registers for the whole
// band (a branchless max/min chain per key). A tile that holds padding
// rows or windows past n_win takes a checked copy of the scoring code.
//
// * C >= 16, the two-phase kernel (stages 2-3: C=64, band 4096): tiles of
//   4 j-steps (256 rows). Phase A: each thread computes the 8 x 8 dots of
//   8 queries and 8 rows, two channels a read (every float read from
//   shared memory feeds 4 FMAs: a 4 x 4 tile, 2 bytes per FMA, held the
//   dots to about a third of the FP32 peak), and writes their keys to a
//   key tile in shared memory. Phase B: each thread inserts the tile's keys
//   of its 16 (query, window) pairs; the next tile's copy overlaps it.
// * C <= 8, the fused kernel (stage 1: C=4, band 2048): 32-query blocks of
//   256 threads, each thread owning 4 queries (in registers) and 2 windows
//   and scoring, keying and inserting its 8 pairs itself; tiles of 16
//   j-steps, double-buffered. At C >= 16 it serves the shapes whose
//   shared memory the two-phase kernel cannot take (many windows).
//
// After the band the lists go to shared memory (aliasing the staging when
// there is one round) and one warp merges each query's: with one round
// each lane holds the heads of windows lane and lane + 32, and k rounds of
// a warp-wide max (__reduce_max_sync) pop the winners in order, all of a
// warp's queries interleaved and branch-free; with more windows, k rounds
// of "largest key below the last winner" over every slot. The wrapper
// (kernels/knn_banded.py::launch_geometry) picks the kernel, the block
// and the tiles from the shape, shrinking them where the shared memory
// would not fit; the launcher refuses (cudaErrorInvalidValue) a geometry
// it cannot take.
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.9; the build log beside the
// library): the two-phase cap-6 C=64 instance 254 registers, no spill,
// 155,648 bytes of shared memory for 64 queries (the lists alias it), 256
// threads, one block (8 warps) per SM; the fused cap-6 C=4 instance 128
// registers (an 8-byte spill), 57,344 bytes for 32 queries, 256 threads,
// two blocks per SM. The cap-8 instances and the fused C >= 16 ones spill
// (none runs on the default path). `cuobjdump -sass`: FFMA, no HMMA or
// GMMA, in every instance.
//
// An optional device predicate `pred` (int32, may be null): when it reads
// 0 every block returns at once, so the caller can skip the kernel's work
// on a decision that lives on the device, without a host sync.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "knn_common.cuh"  // band_start, load_query, cp.async helpers
#include "knn_select.cuh"  // keys, lists, the dot tile, the merge

namespace {

constexpr int kSlots = 64;  // windows per round: the slots of a j-step
constexpr int kQM = 4;      // fused kernel: queries per thread
// fused kernel at C >= 16: 4-channel steps of the dot loop unrolled (the
// full unroll hoists every step's shared-memory reads and spills the lists)
constexpr int kC4Unroll = 4;
constexpr int kTileRows = 4 * kSlots;  // two-phase kernel: 4 j-steps a tile
constexpr int kKeyStride = kTileRows + 8;  // its key tile's row, in ints

// Fused kernel: slots (windows) per thread. RM lists of CAP keys per query
// live in registers, so RM sets the registers and with them the warps an
// SM holds.
template <int CV>
__host__ __device__ constexpr int slots_per_thread() {
  return CV <= 8 ? 2 : 4;
}

// Fused kernel: threads of a 32-query block at C <= 8 (the only block the
// wrapper gives it there) and of a 64-query block at C >= 16.
template <int CV>
__host__ __device__ constexpr int max_threads() {
  return (CV <= 8 ? 8 : 16) * (kSlots / slots_per_thread<CV>());
}

// Fused kernel: blocks an SM must hold. At C <= 8 two (at most 128
// registers a thread), but for cap 8 one: its 64 list registers would spill.
template <int CAP, int CV>
__host__ __device__ constexpr int min_blocks() {
  return CV <= 8 && CAP <= 6 ? 2 : 1;
}

// The band rows of j-steps [t * jt, t * jt + jt) of the round at w0 (row
// t * jt * n_win + j * n_win + w0 + s at tile row j * 64 + s), with their
// norms, by cp.async into `dst` / `dn`, zero-filled where the j-step is
// past the window, the slot past n_win or the row past N; then commits.
template <int CV>
__device__ __forceinline__ void stage_rows(float4* dst, float* dn, const float* xb,
                                           const float* cb, int t, int jt, int w0,
                                           int start, int n_win, int w_sz, int N) {
  constexpr int V = CV / 4, XS4 = row_stride4<CV>();
  const int rows = jt * kSlots;
  for (int i = threadIdx.x; i < rows * V; i += blockDim.x) {
    const int row = i / V, c4 = i % V;
    const int j = t * jt + row / kSlots, w = w0 + row % kSlots;
    const int o = start + j * n_win + w;
    const bool ok = j < w_sz && w < n_win && o < N;
    cp_async16(dst + row * XS4 + c4, ok ? xb + (size_t)o * CV + 4 * c4 : xb, ok);
  }
  for (int row = threadIdx.x; row < rows; row += blockDim.x) {
    const int j = t * jt + row / kSlots, w = w0 + row % kSlots;
    const int o = start + j * n_win + w;
    const bool ok = j < w_sz && w < n_win && o < N;
    cp_async4(dn + row, ok ? cb + o : cb, ok);
  }
  cp_async_commit();
}

// A launch's shared memory (bytes): the staging and the per-window lists,
// which alias the staging when there is one round of windows. The
// wrapper's smem_bytes (kernels/knn_banded.py) is the same.
template <int CV>
size_t smem_bytes(int qb, int jt, int nbuf, int two_phase, int n_win, int cap) {
  const size_t XS4 = row_stride4<CV>();
  size_t staging;
  if (two_phase) {  // queries, one tile of 256 rows and its norms, the key tile
    staging = 16 * (qb + kTileRows) * XS4 + 4 * kTileRows + 4 * (size_t)qb * kKeyStride;
  } else {  // queries (C >= 16), nbuf tiles of jt j-steps and their norms
    const size_t rows = (size_t)jt * kSlots;
    staging = 16 * ((CV <= 8 ? 0 : qb * XS4) + nbuf * rows * XS4) + 4 * nbuf * rows;
  }
  const bool one_round = n_win <= kSlots;
  const size_t lists = 4 * (size_t)qb * n_win * (one_round ? cap + 1 : cap);
  return one_round ? (staging > lists ? staging : lists) : staging + lists;
}

// Fused kernel, one tile's j-steps: the 4 x RM dots of each, their keys,
// the insertions. CHECK: the tile holds padding rows (o >= N: score -inf)
// or slots past n_win (no candidate).
template <int CAP, int CV, bool CHECK>
__device__ __forceinline__ void score_tile(
    int (&top)[kQM][slots_per_thread<CV>()][CAP], const float4* __restrict__ xs4,
    const float* __restrict__ xn, const float4* __restrict__ qs4,
    const float (&qv)[kQM][CV], const float (&qn)[kQM], int tq, int tq_n,
    int tr, int j_first, int j_end, int w0, int start, int N, int band,
    int n_win, int keep_mask) {
  constexpr bool kQReg = CV <= 8;
  constexpr int XS4 = row_stride4<CV>();
  constexpr int kRM = slots_per_thread<CV>(), kTR = kSlots / kRM;
  constexpr int kUnroll = kQReg ? CV / 4 : kC4Unroll;
  for (int j = j_first; j < j_end; ++j) {
    const int jj = j - j_first;
    float acc[kQM][kRM];
#pragma unroll
    for (int a = 0; a < kQM; ++a)
#pragma unroll
      for (int c = 0; c < kRM; ++c) acc[a][c] = 0.f;
    const float4* xrow = xs4 + (jj * kSlots + tr) * XS4;
#pragma unroll (kUnroll)
    for (int c4 = 0; c4 < CV / 4; ++c4) {
      float4 xf[kRM], qf[kQM];
#pragma unroll
      for (int c = 0; c < kRM; ++c) xf[c] = xrow[c * kTR * XS4 + c4];
#pragma unroll
      for (int a = 0; a < kQM; ++a) {
        if constexpr (kQReg) {
          qf[a] = make_float4(qv[a][4 * c4], qv[a][4 * c4 + 1], qv[a][4 * c4 + 2],
                              qv[a][4 * c4 + 3]);
        } else {
          qf[a] = qs4[(tq + tq_n * a) * XS4 + c4];
        }
      }
      // each accumulator runs its own chain, channel after channel; the
      // FMAs of one channel, to different accumulators, issue back to back
#pragma unroll
      for (int a = 0; a < kQM; ++a)
#pragma unroll
        for (int c = 0; c < kRM; ++c) acc[a][c] = fmaf(qf[a].x, xf[c].x, acc[a][c]);
#pragma unroll
      for (int a = 0; a < kQM; ++a)
#pragma unroll
        for (int c = 0; c < kRM; ++c) acc[a][c] = fmaf(qf[a].y, xf[c].y, acc[a][c]);
#pragma unroll
      for (int a = 0; a < kQM; ++a)
#pragma unroll
        for (int c = 0; c < kRM; ++c) acc[a][c] = fmaf(qf[a].z, xf[c].z, acc[a][c]);
#pragma unroll
      for (int a = 0; a < kQM; ++a)
#pragma unroll
        for (int c = 0; c < kRM; ++c) acc[a][c] = fmaf(qf[a].w, xf[c].w, acc[a][c]);
    }
#pragma unroll
    for (int c = 0; c < kRM; ++c) {
      const int s = tr + kTR * c;
      const int r = j * n_win + w0 + s;
      const float xnv = xn[jj * kSlots + s];
      const bool pad = CHECK && start + r >= N;
      const bool none = CHECK && w0 + s >= n_win;
#pragma unroll
      for (int a = 0; a < kQM; ++a) {
        float sc = score(acc[a][c], xnv, qn[a]);
        if (pad) sc = -INFINITY;
        int v = pack_key(sc, band - 1 - r, keep_mask);
        if (none) v = INT_MIN;
        insert<CAP>(top[a][c], v);
      }
    }
  }
}

// The fused kernel (C <= 8; at C >= 16 where the two-phase kernel's shared
// memory does not fit): each thread scores and selects its own 4 x RM
// (query, window) pairs.
template <int CAP, int CV>
__global__ void __launch_bounds__(max_threads<CV>(), min_blocks<CAP, CV>())
knn_banded_kernel(const float* __restrict__ x,      // (B, N, CV)
                  const float* __restrict__ cnorm,  // (B, N)
                  int* __restrict__ out,            // (B, N, K)
                  int* __restrict__ kth,            // (B, N)
                  const int* __restrict__ pred,     // () or null
                  int N, int K, int n_pad, int band, int n_win, int qt,
                  int idx_bits, int jt, int nbuf) {
  if (pred != nullptr && *pred == 0) return;
  constexpr bool kQReg = CV <= 8;
  constexpr int XS4 = row_stride4<CV>();
  constexpr int kRM = slots_per_thread<CV>(), kTR = kSlots / kRM;
  extern __shared__ float4 smem4[];
  const int tq_n = blockDim.x / kTR;
  const int qb = tq_n * kQM;  // queries of the block: 64 or 32
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a warp is 4 query columns by 8 consecutive slots
  const int tr = warp % (kTR / 8) * 8 + (lane & 7);
  const int tq = warp / (kTR / 8) * 4 + (lane >> 3);
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * qb;
  const int start = band_start(q0 / qt, qt, n_pad, band);
  const int w_sz = band / n_win;  // rows per window
  const int rounds = (n_win + kSlots - 1) / kSlots;
  const int tiles = (w_sz + jt - 1) / jt;
  const int rows = jt * kSlots;  // rows of a tile
  const int keep_mask = ~((1 << idx_bits) - 1);

  // staging: [queries qb x XS4 (C >= 16)] [nbuf tiles of rows x XS4]
  // [nbuf tiles of row norms]; then the lists [qb][n_win][LS]
  float4* qs4 = smem4;
  float4* xs4 = qs4 + (kQReg ? 0 : qb * XS4);
  float* xn = reinterpret_cast<float*>(xs4 + nbuf * rows * XS4);
  const size_t staging_b = 16 * ((kQReg ? 0 : (size_t)qb * XS4) + (size_t)nbuf * rows * XS4) +
                           4 * (size_t)nbuf * rows;
  int* lists = reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) +
                                      (rounds == 1 ? 0 : staging_b));
  const int LS = rounds == 1 ? CAP + 1 : CAP;

  const float* xb = x + (size_t)b * N * CV;
  const float* cb = cnorm + (size_t)b * N;
  float qv[kQM][CV];
  float qn[kQM];
#pragma unroll
  for (int a = 0; a < kQM; ++a) {
    const int qi = min(q0 + tq + tq_n * a, N - 1);
    qn[a] = cb[qi];
    if constexpr (kQReg) load_query<CV>(qv[a], xb + (size_t)qi * CV);
  }
  if constexpr (!kQReg) stage_queries<CV>(qs4, xb, q0, qb, N);

  for (int rd = 0; rd < rounds; ++rd) {
    const int w0 = rd * kSlots;
    int top[kQM][kRM][CAP];
#pragma unroll
    for (int a = 0; a < kQM; ++a)
#pragma unroll
      for (int c = 0; c < kRM; ++c)
#pragma unroll
        for (int i = 0; i < CAP; ++i) top[a][c][i] = INT_MIN;
    // with the queries' copies, in the first round
    stage_rows<CV>(xs4, xn, xb, cb, 0, jt, w0, start, n_win, w_sz, N);
    for (int t = 0; t < tiles; ++t) {
      const int buf = nbuf == 2 ? (t & 1) : 0;
      if (nbuf == 2 && t + 1 < tiles) {
        stage_rows<CV>(xs4 + (buf ^ 1) * rows * XS4, xn + (buf ^ 1) * rows, xb, cb, t + 1,
                       jt, w0, start, n_win, w_sz, N);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int j_first = t * jt, j_end = min(j_first + jt, w_sz);
      const int last_w = min(w0 + kSlots, n_win) - 1;
      const bool check = w0 + kSlots > n_win ||
                         start + (j_end - 1) * n_win + last_w >= N;
      const float4* xt = xs4 + buf * rows * XS4;
      const float* nt = xn + buf * rows;
      if (check) {
        score_tile<CAP, CV, true>(top, xt, nt, qs4, qv, qn, tq, tq_n, tr, j_first,
                                  j_end, w0, start, N, band, n_win, keep_mask);
      } else {
        score_tile<CAP, CV, false>(top, xt, nt, qs4, qv, qn, tq, tq_n, tr, j_first,
                                   j_end, w0, start, N, band, n_win, keep_mask);
      }
      __syncthreads();  // the buffer is free for the next copy
      if (nbuf == 1 && t + 1 < tiles)
        stage_rows<CV>(xs4, xn, xb, cb, t + 1, jt, w0, start, n_win, w_sz, N);
    }
    // the round's lists (past the last barrier: the staging is free)
#pragma unroll
    for (int a = 0; a < kQM; ++a)
#pragma unroll
      for (int c = 0; c < kRM; ++c) {
        const int w = w0 + tr + kTR * c;
        if (w < n_win) {
          int* l = lists + ((tq + tq_n * a) * n_win + w) * LS;
#pragma unroll
          for (int i = 0; i < CAP; ++i) l[i] = top[a][c][i];
          if (rounds == 1) l[CAP] = INT_MIN;
        }
      }
  }
  __syncthreads();
  merge_lists<CAP, 2 * kRM>(lists, rounds == 1, qb, q0, b, N, K, n_win, start, band,
                            ~keep_mask, out, kth);
}

// Two-phase kernel, phase A of one tile (256 rows = 4 j-steps): the 8 x 8
// dots of queries ty + TY * i and tile rows tx + 32 * i (tile_dots), then
// their keys into the key tile [qb][kKeyStride].
template <int CV, bool CHECK>
__device__ __forceinline__ void tile_keys(const float4* __restrict__ qs4,
                                          const float4* __restrict__ xs4,
                                          const float* __restrict__ xn,
                                          const float (&qn)[8], int* __restrict__ keys,
                                          int ty, int TY, int tx, int j0, int w_sz,
                                          int w0, int start, int N, int band, int n_win,
                                          int keep_mask) {
  float acc[8][8];
  tile_dots<CV>(acc, qs4, xs4, ty, TY, tx);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int row = tx + 32 * c;  // tile row: j-step row / 64, slot row % 64
    const int j = j0 + row / kSlots, s = row % kSlots;
    const int r = j * n_win + w0 + s;
    const float xnv = xn[row];
    const bool pad = CHECK && start + r >= N;
    const bool none = CHECK && (w0 + s >= n_win || j >= w_sz);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float sc = score(acc[a][c], xnv, qn[a]);
      if (pad) sc = -INFINITY;
      int v = pack_key(sc, band - 1 - r, keep_mask);
      if (none) v = INT_MIN;
      keys[(ty + TY * a) * kKeyStride + row] = v;
    }
  }
}

// The two-phase kernel (C >= 16). A block owns qb queries (64: 256
// threads; 32: 128) and walks the band in tiles of 4 j-steps (256 rows).
// Phase A: thread (ty, tx) computes the 8 x 8 dots of queries ty + TY * i
// and rows tx + 32 * i (two channels a read: each float from shared memory
// feeds 4 FMAs) and writes their keys to a key tile. Phase B: thread t
// owns window slot t % 64 of queries t / 64 + (threads / 64) * i, i < 16,
// and inserts the tile's keys of its 16 pairs into their lists, held in
// registers for the whole band. The next tile's copy overlaps phase B.
template <int CAP, int CV>
__global__ void __launch_bounds__(256, 1)
knn_banded_tile_kernel(const float* __restrict__ x, const float* __restrict__ cnorm,
                       int* __restrict__ out, int* __restrict__ kth,
                       const int* __restrict__ pred, int N, int K, int n_pad,
                       int band, int n_win, int qt, int idx_bits) {
  if (pred != nullptr && *pred == 0) return;
  constexpr int XS4 = row_stride4<CV>();
  extern __shared__ float4 smem4[];
  const int TY = blockDim.x >> 5;  // 8 or 4
  const int qb = 8 * TY;           // queries of the block: 64 or 32
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // phase A: a warp is 4 query rows by 8 consecutive tile rows
  const int tx = (warp & 3) * 8 + (lane & 7);
  const int ty = (warp >> 2) * 4 + (lane >> 3);
  // phase B: one window slot, 16 queries
  const int pw = tid % kSlots, pq = tid / kSlots, pstep = blockDim.x / kSlots;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * qb;
  const int start = band_start(q0 / qt, qt, n_pad, band);
  const int w_sz = band / n_win;
  const int rounds = (n_win + kSlots - 1) / kSlots;
  const int tiles = (w_sz + 3) / 4;
  const int keep_mask = ~((1 << idx_bits) - 1);

  // staging: [queries qb x XS4] [tile 256 x XS4] [norms 256] [keys qb x
  // kKeyStride]; then the lists [qb][n_win][LS]
  float4* qs4 = smem4;
  float4* xs4 = qs4 + qb * XS4;
  float* xn = reinterpret_cast<float*>(xs4 + kTileRows * XS4);
  int* keys = reinterpret_cast<int*>(xn + kTileRows);
  const size_t staging_b =
      16 * (size_t)(qb + kTileRows) * XS4 + 4 * kTileRows + 4 * (size_t)qb * kKeyStride;
  int* lists = reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) +
                                      (rounds == 1 ? 0 : staging_b));
  const int LS = rounds == 1 ? CAP + 1 : CAP;

  const float* xb = x + (size_t)b * N * CV;
  const float* cb = cnorm + (size_t)b * N;
  float qn[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) qn[a] = cb[min(q0 + ty + TY * a, N - 1)];
  stage_queries<CV>(qs4, xb, q0, qb, N);

  for (int rd = 0; rd < rounds; ++rd) {
    const int w0 = rd * kSlots;
    int top[16][CAP];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int c = 0; c < CAP; ++c) top[i][c] = INT_MIN;
    stage_rows<CV>(xs4, xn, xb, cb, 0, 4, w0, start, n_win, w_sz, N);
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait<0>();
      __syncthreads();  // the tile has arrived; phase B of the last one is done
      const int j0 = 4 * t, jn = min(4, w_sz - j0);
      const int last_w = min(w0 + kSlots, n_win) - 1;
      const bool check = jn < 4 || w0 + kSlots > n_win ||
                         start + (j0 + jn - 1) * n_win + last_w >= N;
      if (check) {
        tile_keys<CV, true>(qs4, xs4, xn, qn, keys, ty, TY, tx, j0, w_sz, w0, start, N,
                            band, n_win, keep_mask);
      } else {
        tile_keys<CV, false>(qs4, xs4, xn, qn, keys, ty, TY, tx, j0, w_sz, w0, start, N,
                             band, n_win, keep_mask);
      }
      __syncthreads();  // the keys are written; the tile is free
      if (t + 1 < tiles) stage_rows<CV>(xs4, xn, xb, cb, t + 1, 4, w0, start, n_win, w_sz, N);
      for (int jj = 0; jj < jn; ++jj) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          insert<CAP>(top[i], keys[(pq + pstep * i) * kKeyStride + jj * kSlots + pw]);
      }
    }
    __syncthreads();  // every phase B has read the keys (the lists may alias them)
    const int w = w0 + pw;
    if (w < n_win) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        int* l = lists + ((pq + pstep * i) * n_win + w) * LS;
#pragma unroll
        for (int c = 0; c < CAP; ++c) l[c] = top[i][c];
        if (rounds == 1) l[CAP] = INT_MIN;
      }
    }
  }
  __syncthreads();
  merge_lists<CAP, 8>(lists, rounds == 1, qb, q0, b, N, K, n_win, start, band,
                      ~keep_mask, out, kth);
}

template <int CAP, int CV>
cudaError_t launch(const float* x, const float* cnorm, int* out, int* kth,
                   const int* pred, int B, int N, int K, int n_pad, int band,
                   int n_win, int qt, int idx_bits, int qb, int jt, int nbuf,
                   int two_phase, cudaStream_t stream) {
  if ((qb != 64 && qb != 32) || qt % qb || jt < 1 || (nbuf != 1 && nbuf != 2) ||
      n_win < 1 || band % n_win || (two_phase && CV <= 8) ||
      (!two_phase && qb / kQM * (kSlots / slots_per_thread<CV>()) > max_threads<CV>()))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<CV>(qb, jt, nbuf, two_phase, n_win, CAP);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)limit) return cudaErrorInvalidValue;
  const dim3 grid((N + qb - 1) / qb, B);
  if (two_phase) {
    if constexpr (CV > 8) {
      auto kernel = knn_banded_tile_kernel<CAP, CV>;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, qb / 8 * 32, smem, stream>>>(x, cnorm, out, kth, pred, N, K, n_pad,
                                                  band, n_win, qt, idx_bits);
    }
  } else {
    auto kernel = knn_banded_kernel<CAP, CV>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, qb / kQM * (kSlots / slots_per_thread<CV>()), smem, stream>>>(
        x, cnorm, out, kth, pred, N, K, n_pad, band, n_win, qt, idx_bits, jt, nbuf);
  }
  return cudaGetLastError();
}

template <int CAP>
cudaError_t launch_cv(int cv, const float* x, const float* cnorm, int* out,
                      int* kth, const int* pred, int B, int N, int K,
                      int n_pad, int band, int n_win, int qt, int idx_bits,
                      int qb, int jt, int nbuf, int two_phase, cudaStream_t s) {
  switch (cv) {
    case 4: return launch<CAP, 4>(x, cnorm, out, kth, pred, B, N, K, n_pad, band, n_win, qt, idx_bits, qb, jt, nbuf, two_phase, s);
    case 8: return launch<CAP, 8>(x, cnorm, out, kth, pred, B, N, K, n_pad, band, n_win, qt, idx_bits, qb, jt, nbuf, two_phase, s);
    case 16: return launch<CAP, 16>(x, cnorm, out, kth, pred, B, N, K, n_pad, band, n_win, qt, idx_bits, qb, jt, nbuf, two_phase, s);
    case 32: return launch<CAP, 32>(x, cnorm, out, kth, pred, B, N, K, n_pad, band, n_win, qt, idx_bits, qb, jt, nbuf, two_phase, s);
    case 64: return launch<CAP, 64>(x, cnorm, out, kth, pred, B, N, K, n_pad, band, n_win, qt, idx_bits, qb, jt, nbuf, two_phase, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B,N,cv) with cv in {4,8,16,32,64} (zero-padded channels), cnorm (B,N);
// out (B,N,K) int32, kth (B,N) int32; pred a device int32 or null. qt is a
// multiple of qb; n_pad >= band; band % n_win == 0. qb (64 or 32 queries
// per block), jt (j-steps per staged tile) and nbuf (1 or 2 tile buffers)
// of the fused kernel, or two_phase (C >= 16): the wrapper's
// launch_geometry. Returns a cudaError_t.
extern "C" int dgcnn_knn_banded(const float* x, const float* cnorm, int* out,
                                int* kth, const int* pred, int B, int N,
                                int cv, int K, int n_pad, int band, int n_win,
                                int cap, int qt, int idx_bits, int qb, int jt,
                                int nbuf, int two_phase, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cap) {
    case 4: return launch_cv<4>(cv, x, cnorm, out, kth, pred, B, N, K, n_pad, band, n_win, qt, idx_bits, qb, jt, nbuf, two_phase, s);
    case 6: return launch_cv<6>(cv, x, cnorm, out, kth, pred, B, N, K, n_pad, band, n_win, qt, idx_bits, qb, jt, nbuf, two_phase, s);
    case 8: return launch_cv<8>(cv, x, cnorm, out, kth, pred, B, N, K, n_pad, band, n_win, qt, idx_bits, qb, jt, nbuf, two_phase, s);
    default: return cudaErrorInvalidValue;
  }
}
