// Capped packed-key k-nearest-neighbour selection for Hopper (sm_90a).
//
// Replaces dgcnn_tpu/kernels/knn_pallas.py::_knn_kernel_packed_capped
// (launched from _knn_pallas_jit through knn_pallas(packed=True, cap>0)).
// It computes exactly what that kernel computes:
//
//   score(q, o) = (2 * <x_o, q> - |x_o|^2) - |q|^2      (FP32, FMA dot)
//   key         = monotone_int(score) >> 1, low idx_bits replaced by
//                 (n_pad - 1 - o)                          (unique per query)
//   per window w = { o : o % n_win == w } keep the top-`cap` keys,
//   then merge the n_win * cap winners to the top-k, largest key first.
//
// Rows o >= N are the padding of the TPU kernel: their score is -inf.
//
// What bounds it on the H100: the score is a dot product of width C for
// every (query, candidate) pair, B*M*n_pad*C FP32 FMAs (25.7 G at B=8,
// M=N=7000, C=64: 0.749 ms at 67 TFLOP/s), plus per pair the score's two
// subtractions, the key and the insertion into the window's list (integer
// min/max, at half the FMA rate): at C=4 the selection, not the dot, is
// the work. No tensor-core work: TF32 would flip rankings (the port's FP32
// policy), and 3xTF32 sums in another order.
//
// Bit-equality. Every dot is one fmaf chain over channels 0..CV-1 from
// 0.f, then the two explicitly rounded subtractions (knn_select.cuh); the
// keys are unique per query (their low bits), so the per-window top-cap
// and the merge are functions of the keys alone, whatever order the rows
// are scored or split in. So this kernel returns the indices of the
// kernel it replaced (one query per lane) on every input, floats included.
//
// Design. Window w is the residue class o % n_win, so the rows j * n_win +
// w0 + s (s < G) of a j-step hold one candidate of each window of the
// group [w0, w0 + G). A block owns a tile of queries and one group of G
// windows (G <= 32) and walks the group's rows in tiles of j-steps, staged
// by cp.async (16 bytes a thread, zero-filled past N) into rows of an odd
// float4 stride. Each (query, window) pair keeps its sorted top-cap keys
// in registers (a branchless max/min chain per key). The wrapper
// (kernels/knn_capped.py::launch_geometry) picks the split:
//
// * self-kNN (thousands of queries): one group of all n_win windows (n_win
//   <= 32; 28 at N=7000, window 256), so the lists go to shared memory
//   (aliasing the staging) and the block merges them: a warp max over the
//   heads of the lists, k rounds, branch-free (knn_select.cuh).
// * few queries (the recall guard's 64 or 256 probes): the windows split
//   over the grid's z (2 or 7 windows a block at M = 64 / 256), so the
//   grid fills the card; each block writes its lists to a global (B, M,
//   n_win, cap) buffer and knn_capped_kernel_merge merges them. Splitting
//   is exact: a window's top-cap needs only that window's rows.
//
// * C >= 16, the two-phase kernel (stages 2-3 and the probes: C=64): 64
//   queries x 256 staged rows (256 / G j-steps) a tile. Phase A: each
//   thread computes the 8 x 8 dots of 8 queries and 8 rows (tile_dots: two
//   channels a read, 1 byte of shared memory per FMA) and writes their
//   keys to a key tile. Phase B: each thread inserts the tile's keys of its
//   (query, window) pairs, up to 8 lists (7 at 64 queries x 28 windows);
//   the next tile's copy overlaps it.
// * C <= 8, the fused kernel (stage 1: C=4): each thread owns one window
//   and 4 queries (in registers) and scores, keys and inserts its 4 pairs
//   of each j-step itself; G x (queries / 4) threads, tiles of 32 j-steps,
//   double-buffered.
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.8; the build log beside the
// library): the two-phase instances 254 registers, no spill, 155,648 bytes
// of shared memory at C=64 with 64 queries (the lists alias it), 256
// threads, one block (8 warps) per SM; the fused cap-8 C=4 instance 114
// registers, no spill, 36,288 bytes at 36 queries x 28 windows (252 of 256
// threads), two blocks per SM; the merge kernel 30 registers. Code
// (cuobjdump -sass): 1,024 FFMA in each two-phase instance, FFMA in the
// fused ones, no HMMA or GMMA in any.
//
// An optional device predicate `pred` (int32, may be null): when it reads
// 0 every block of both launches returns at once, so a fallback or a
// guard probe whose use is decided on the device costs no work when it is
// not taken.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "knn_common.cuh"  // load_query, cp.async helpers
#include "knn_select.cuh"  // keys, lists, the dot tile, the merge

namespace {

constexpr int kMaxGroup = 32;   // windows of a block's group
constexpr int kTileRows = 256;  // two-phase kernel: rows of a staged tile
constexpr int kKeyStride = kTileRows + 8;  // its key tile's row, in ints
constexpr int kLists = 8;       // two-phase kernel: (query, window) lists a thread
constexpr int kQM = 4;          // fused kernel: queries a thread
constexpr int kMergeQueries = 8;  // merge kernel: queries a block, a warp each

// row / G for a tile row (< 3293, G <= 32) by a multiply: gm = ceil(2^16 / G)
__device__ __forceinline__ int div_group(int row, int gm) { return (row * gm) >> 16; }

// The rows of j-steps [j0, j0 + jn) of the window group at w0 (row j *
// n_win + w0 + s at tile row (j - j0) * G + s), with their norms, by
// cp.async into `dst` / `dn`, zero-filled where the j-step is past the
// window, the slot past n_win or the row past N; then commits.
template <int CV>
__device__ __forceinline__ void stage_rows(float4* dst, float* dn, const float* xb,
                                           const float* cb, int j0, int jn, int G, int gm,
                                           int w0, int n_win, int window, int N) {
  constexpr int V = CV / 4, XS4 = row_stride4<CV>();
  const int rows = jn * G;
  for (int i = threadIdx.x; i < rows * V; i += blockDim.x) {
    const int row = i / V, c4 = i % V;
    const int jr = div_group(row, gm);
    const int j = j0 + jr, w = w0 + row - jr * G;
    const int o = j * n_win + w;
    const bool ok = j < window && w < n_win && o < N;
    cp_async16(dst + row * XS4 + c4, ok ? xb + (size_t)o * CV + 4 * c4 : xb, ok);
  }
  for (int row = threadIdx.x; row < rows; row += blockDim.x) {
    const int jr = div_group(row, gm);
    const int j = j0 + jr, w = w0 + row - jr * G;
    const int o = j * n_win + w;
    const bool ok = j < window && w < n_win && o < N;
    cp_async4(dn + row, ok ? cb + o : cb, ok);
  }
  cp_async_commit();
}

// A (query, window) list after the scan: to the block's lists in shared
// memory ([qb][n_win][CAP + 1], a sentinel closing each) when the block
// owns every window, else to the global (B, M, n_win, CAP) buffer.
template <int CAP>
__device__ __forceinline__ void put_list(const int (&top)[CAP], int* slists, int* glists,
                                         int ql, int w, int q0, int b, int M, int n_win) {
  if (glists == nullptr) {
    int* l = slists + (ql * n_win + w) * (CAP + 1);
#pragma unroll
    for (int i = 0; i < CAP; ++i) l[i] = top[i];
    l[CAP] = INT_MIN;
  } else if (q0 + ql < M) {
    int* l = glists + (((size_t)b * M + q0 + ql) * n_win + w) * CAP;
#pragma unroll
    for (int i = 0; i < CAP; ++i) l[i] = top[i];
  }
}

// Fused kernel, one tile's j-steps [j_first, j_end): the 4 dots of each
// (the thread's window slot s, its 4 queries), their keys, the insertions.
// CHECK: the tile holds padding rows (o >= N: score -inf).
template <int CAP, int CV, bool CHECK>
__device__ __forceinline__ void fused_rows(int (&top)[kQM][CAP], const float4* __restrict__ xs4,
                                           const float* __restrict__ xn,
                                           const float (&qv)[kQM][CV], const float (&qn)[kQM],
                                           int s, int G, int j_first, int j_end, int w0,
                                           int n_win, int n_pad, int N, int keep_mask) {
  constexpr int XS4 = row_stride4<CV>();
  for (int j = j_first; j < j_end; ++j) {
    const int row = (j - j_first) * G + s;
    const int o = j * n_win + w0 + s;
    float acc[kQM];
#pragma unroll
    for (int a = 0; a < kQM; ++a) acc[a] = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < CV / 4; ++c4) {
      const float4 v = xs4[row * XS4 + c4];
      // each accumulator's chain runs channel after channel
#pragma unroll
      for (int a = 0; a < kQM; ++a) acc[a] = fmaf(qv[a][4 * c4], v.x, acc[a]);
#pragma unroll
      for (int a = 0; a < kQM; ++a) acc[a] = fmaf(qv[a][4 * c4 + 1], v.y, acc[a]);
#pragma unroll
      for (int a = 0; a < kQM; ++a) acc[a] = fmaf(qv[a][4 * c4 + 2], v.z, acc[a]);
#pragma unroll
      for (int a = 0; a < kQM; ++a) acc[a] = fmaf(qv[a][4 * c4 + 3], v.w, acc[a]);
    }
    const float xnv = xn[row];
    const bool pad = CHECK && o >= N;
#pragma unroll
    for (int a = 0; a < kQM; ++a) {
      float sc = score(acc[a], xnv, qn[a]);
      if (pad) sc = -INFINITY;
      insert<CAP>(top[a], pack_key(sc, n_pad - 1 - o, keep_mask));
    }
  }
}

// The fused kernel (C <= 8): thread t < G * qb / 4 owns window slot t % G
// of the block's group and queries t / G + (qb / 4) * a, a < 4.
template <int CAP, int CV>
__global__ void __launch_bounds__(256, 2)
knn_capped_kernel_fused(const float* __restrict__ x,      // (B, N, CV)
                        const float* __restrict__ q,      // (B, M, CV)
                        const float* __restrict__ cnorm,  // (B, N)
                        const float* __restrict__ qnorm,  // (B, M)
                        int* __restrict__ out,            // (B, M, K)
                        int* __restrict__ glists,         // (B, M, n_win, CAP) or null
                        const int* __restrict__ pred,     // () or null
                        int N, int M, int K, int n_pad, int n_win, int window,
                        int idx_bits, int qb, int G, int jt, int nbuf) {
  if (pred != nullptr && *pred == 0) return;
  constexpr int XS4 = row_stride4<CV>();
  extern __shared__ float4 smem4[];
  const int qg = qb / kQM;  // query columns
  const int tid = threadIdx.x;
  const bool active = tid < G * qg;
  const int s = tid % G, g = min(tid / G, qg - 1);
  const int b = blockIdx.y, q0 = blockIdx.x * qb, w0 = blockIdx.z * G;
  const int rows = jt * G;  // rows of a tile
  const int gm = (65536 + G - 1) / G;
  const int tiles = (window + jt - 1) / jt;
  const int keep_mask = ~((1 << idx_bits) - 1);

  // staging: nbuf tiles of rows x XS4, then nbuf tiles of row norms; the
  // lists alias it after the scan
  float4* xs4 = smem4;
  float* xn = reinterpret_cast<float*>(xs4 + nbuf * rows * XS4);
  const float* xb = x + (size_t)b * N * CV;
  const float* cb = cnorm + (size_t)b * N;

  float qv[kQM][CV];
  float qn[kQM];
#pragma unroll
  for (int a = 0; a < kQM; ++a) {
    const int qi = min(q0 + g + qg * a, M - 1);
    qn[a] = qnorm[(size_t)b * M + qi];
    load_query<CV>(qv[a], q + ((size_t)b * M + qi) * CV);
  }
  int top[kQM][CAP];
#pragma unroll
  for (int a = 0; a < kQM; ++a)
#pragma unroll
    for (int i = 0; i < CAP; ++i) top[a][i] = INT_MIN;

  stage_rows<CV>(xs4, xn, xb, cb, 0, min(jt, window), G, gm, w0, n_win, window, N);
  for (int t = 0; t < tiles; ++t) {
    const int buf = nbuf == 2 ? (t & 1) : 0;
    const int j_first = t * jt, j_end = min(j_first + jt, window);
    if (nbuf == 2 && t + 1 < tiles) {
      stage_rows<CV>(xs4 + (buf ^ 1) * rows * XS4, xn + (buf ^ 1) * rows, xb, cb, j_end,
                     min(jt, window - j_end), G, gm, w0, n_win, window, N);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool check = (j_end - 1) * n_win + min(w0 + G, n_win) - 1 >= N;
    if (active) {
      const float4* xt = xs4 + buf * rows * XS4;
      const float* nt = xn + buf * rows;
      if (check) {
        fused_rows<CAP, CV, true>(top, xt, nt, qv, qn, s, G, j_first, j_end, w0, n_win,
                                  n_pad, N, keep_mask);
      } else {
        fused_rows<CAP, CV, false>(top, xt, nt, qv, qn, s, G, j_first, j_end, w0, n_win,
                                   n_pad, N, keep_mask);
      }
    }
    __syncthreads();  // the buffer is free for the next copy
    if (nbuf == 1 && t + 1 < tiles)
      stage_rows<CV>(xs4, xn, xb, cb, j_end, min(jt, window - j_end), G, gm, w0, n_win,
                     window, N);
  }
  // past the last barrier: the staging is free for the lists
  int* slists = reinterpret_cast<int*>(smem4);
  if (active && w0 + s < n_win) {
#pragma unroll
    for (int a = 0; a < kQM; ++a)
      put_list<CAP>(top[a], slists, glists, g + qg * a, w0 + s, q0, b, M, n_win);
  }
  if (glists != nullptr) return;
  __syncthreads();
  merge_lists<CAP, 8, true>(slists, true, qb, q0, b, M, K, n_win, 0, n_pad, ~keep_mask,
                            out, nullptr);
}

// Two-phase kernel, phase B of one tile: the keys of j-steps jj = p, p +
// P, ... < jn into the thread's first L lists (key columns kofs[i] + jj *
// G), each list's chain interleaved with the others'.
template <int CAP, int L>
__device__ __forceinline__ void insert_tile(int (&top)[kLists][CAP], const int* __restrict__ keys,
                                            const int (&kofs)[kLists], int p, int P, int jn,
                                            int G) {
  for (int jj = p; jj < jn; jj += P) {
    const int* kj = keys + jj * G;
#pragma unroll
    for (int i = 0; i < L; ++i) insert<CAP>(top[i], kj[kofs[i]]);
  }
}

// Two-phase kernel, phase A of one tile: the 8 x 8 dots of queries ty + TY
// * a and tile rows tx + 32 * c (tile_dots), then their keys into the key
// tile [qb][kKeyStride]. Tile row tx + 32 * c is row `base + roff[c]` of the
// table. CHECK: the tile holds padding rows (o >= N: score -inf). Key
// columns past the tile's j-steps are written but never read.
template <int CV, bool CHECK>
__device__ __forceinline__ void tile_keys(const float4* __restrict__ qs4,
                                          const float4* __restrict__ xs4,
                                          const float* __restrict__ xn, const float (&qn)[8],
                                          int* __restrict__ keys, const int (&roff)[8],
                                          int ty, int TY, int tx, int base, int n_pad, int N,
                                          int keep_mask) {
  float acc[8][8];
  tile_dots<CV>(acc, qs4, xs4, ty, TY, tx);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int row = tx + 32 * c;
    const int o = base + roff[c];
    const float xnv = xn[row];
    const bool pad = CHECK && o >= N;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float sc = score(acc[a][c], xnv, qn[a]);
      if (pad) sc = -INFINITY;
      keys[(ty + TY * a) * kKeyStride + row] = pack_key(sc, n_pad - 1 - o, keep_mask);
    }
  }
}

// The two-phase kernel (C >= 16). A block owns qb queries (64: 256
// threads; 32: 128) and one group of G windows, and walks the group's rows
// in tiles of J = 256 / G j-steps (J * G rows). Phase A: thread (ty, tx)
// computes the 8 x 8 dots of queries ty + TY * i and rows tx + 32 * i and
// writes their keys to a key tile. Phase B: thread t owns the lists l = t
// + threads * i (i < 8, l < qb * G) of query l / G and window slot l % G,
// and inserts the tile's keys of each; where the lists are fewer than the
// threads (the probes' one or two windows a block), P threads share each
// list, one taking every P-th j-step, and merge their parts after the
// scan. The next tile's copy overlaps phase B.
template <int CAP, int CV>
__global__ void __launch_bounds__(256, 1)
knn_capped_kernel_tiled(const float* __restrict__ x, const float* __restrict__ q,
                        const float* __restrict__ cnorm, const float* __restrict__ qnorm,
                        int* __restrict__ out, int* __restrict__ glists,
                        const int* __restrict__ pred, int N, int M, int K, int n_pad,
                        int n_win, int window, int idx_bits, int G) {
  if (pred != nullptr && *pred == 0) return;
  constexpr int XS4 = row_stride4<CV>();
  extern __shared__ float4 smem4[];
  const int TY = blockDim.x >> 5;  // 8 or 4
  const int qb = 8 * TY;           // queries of the block: 64 or 32
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // phase A: a warp is 4 query rows by 8 consecutive tile rows
  const int tx = (warp & 3) * 8 + (lane & 7);
  const int ty = (warp >> 2) * 4 + (lane >> 3);
  const int b = blockIdx.y, q0 = blockIdx.x * qb, w0 = blockIdx.z * G;
  const int J = kTileRows / G;  // j-steps of a tile
  const int gm = (65536 + G - 1) / G;
  const int tiles = (window + J - 1) / J;
  const int keep_mask = ~((1 << idx_bits) - 1);

  // staging: [queries qb x XS4] [tile 256 x XS4] [norms 256] [keys qb x
  // kKeyStride]; the lists alias it after the scan
  float4* qs4 = smem4;
  float4* xs4 = qs4 + qb * XS4;
  float* xn = reinterpret_cast<float*>(xs4 + kTileRows * XS4);
  int* keys = reinterpret_cast<int*>(xn + kTileRows);

  const float* xb = x + (size_t)b * N * CV;
  const float* cb = cnorm + (size_t)b * N;
  float qn[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) qn[a] = qnorm[(size_t)b * M + min(q0 + ty + TY * a, M - 1)];
  stage_queries<CV>(qs4, q + (size_t)b * M * CV, q0, qb, M);  // committed with tile 0
  // tile row tx + 32 * c holds row (j0 + j) * n_win + w0 + s of the table,
  // j = row / G, s = row % G: its offset from j0 * n_win + w0
  int roff[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int row = tx + 32 * c;
    roff[c] = row / G * n_win + row % G;
  }
  // phase B: the thread's lists l = l0 + lstep * i, i < nl (nl is
  // warp-uniform: NL is a multiple of 32), each taking the j-steps p, p +
  // P, ... of every tile; with fewer lists than threads, P threads share a
  // list (part p of its rows) and combine their parts after the scan
  const int NL = qb * G;
  const int P = NL < (int)blockDim.x && blockDim.x % NL == 0 ? blockDim.x / NL : 1;
  const int p = tid / NL % P, l0 = P > 1 ? tid % NL : tid, lstep = blockDim.x;
  const int nl = max(0, min(kLists, (NL - l0 + lstep - 1) / lstep));
  int kofs[kLists];  // list i's key column in the key tile
#pragma unroll
  for (int i = 0; i < kLists; ++i) {
    const int l = min(l0 + lstep * i, NL - 1);
    kofs[i] = l / G * kKeyStride + l % G;
  }
  int top[kLists][CAP];
#pragma unroll
  for (int i = 0; i < kLists; ++i)
#pragma unroll
    for (int c = 0; c < CAP; ++c) top[i][c] = INT_MIN;

  stage_rows<CV>(xs4, xn, xb, cb, 0, min(J, window), G, gm, w0, n_win, window, N);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // the tile has arrived; phase B of the last one is done
    const int j0 = t * J, jn = min(J, window - j0);
    const bool check = (j0 + jn - 1) * n_win + min(w0 + G, n_win) - 1 >= N;
    if (check) {
      tile_keys<CV, true>(qs4, xs4, xn, qn, keys, roff, ty, TY, tx, j0 * n_win + w0, n_pad,
                          N, keep_mask);
    } else {
      tile_keys<CV, false>(qs4, xs4, xn, qn, keys, roff, ty, TY, tx, j0 * n_win + w0, n_pad,
                           N, keep_mask);
    }
    __syncthreads();  // the keys are written; the tile is free
    if (t + 1 < tiles)
      stage_rows<CV>(xs4, xn, xb, cb, j0 + J, min(J, window - j0 - J), G, gm, w0, n_win,
                     window, N);
    switch (nl) {  // warp-uniform
      case 8: insert_tile<CAP, 8>(top, keys, kofs, p, P, jn, G); break;
      case 7: insert_tile<CAP, 7>(top, keys, kofs, p, P, jn, G); break;
      case 6: insert_tile<CAP, 6>(top, keys, kofs, p, P, jn, G); break;
      case 5: insert_tile<CAP, 5>(top, keys, kofs, p, P, jn, G); break;
      case 4: insert_tile<CAP, 4>(top, keys, kofs, p, P, jn, G); break;
      case 3: insert_tile<CAP, 3>(top, keys, kofs, p, P, jn, G); break;
      case 2: insert_tile<CAP, 2>(top, keys, kofs, p, P, jn, G); break;
      case 1: insert_tile<CAP, 1>(top, keys, kofs, p, P, jn, G); break;
      default: break;
    }
  }
  __syncthreads();  // every phase B has read the keys (the lists alias them)
  if (P > 1) {  // one list: parts 1 .. P-1 into part 0, through the key tile
    if (p > 0) {
#pragma unroll
      for (int c = 0; c < CAP; ++c) keys[((p - 1) * NL + l0) * CAP + c] = top[0][c];
    }
    __syncthreads();
    if (p == 0) {
      for (int r = 1; r < P; ++r)
#pragma unroll
        for (int c = 0; c < CAP; ++c) insert<CAP>(top[0], keys[((r - 1) * NL + l0) * CAP + c]);
    }
  }
  int* slists = reinterpret_cast<int*>(smem4);
#pragma unroll
  for (int i = 0; i < kLists; ++i) {
    const int l = l0 + lstep * i;
    if (i < nl && p == 0 && w0 + l % G < n_win)
      put_list<CAP>(top[i], slists, glists, l / G, w0 + l % G, q0, b, M, n_win);
  }
  if (glists != nullptr) return;
  __syncthreads();
  merge_lists<CAP, 8, true>(slists, true, qb, q0, b, M, K, n_win, 0, n_pad, ~keep_mask,
                            out, nullptr);
}

// The merge of the global lists (B, M, n_win, CAP) of a split launch: a
// block takes 8 queries, a warp each, into shared memory, then merges.
template <int CAP>
__global__ void __launch_bounds__(32 * kMergeQueries)
knn_capped_kernel_merge(const int* __restrict__ glists, int* __restrict__ out,
                        const int* __restrict__ pred, int M, int K, int n_pad, int n_win,
                        int idx_bits) {
  if (pred != nullptr && *pred == 0) return;
  extern __shared__ int sl[];  // [8][n_win][LS]
  const bool one_round = n_win <= 64;
  const int LS = one_round ? CAP + 1 : CAP;
  const int b = blockIdx.y, q0 = blockIdx.x * kMergeQueries;
  const int per_q = n_win * CAP;
  for (int i = threadIdx.x; i < kMergeQueries * per_q; i += blockDim.x) {
    const int ql = i / per_q, r = i % per_q;
    const int qq = min(q0 + ql, M - 1);
    sl[(ql * n_win + r / CAP) * LS + r % CAP] =
        glists[((size_t)b * M + qq) * per_q + r];
  }
  if (one_round)
    for (int i = threadIdx.x; i < kMergeQueries * n_win; i += blockDim.x)
      sl[i * LS + CAP] = INT_MIN;
  __syncthreads();
  merge_lists<CAP, 1, true>(sl, one_round, kMergeQueries, q0, b, M, K, n_win, 0, n_pad,
                            (1 << idx_bits) - 1, out, nullptr);
}

// A launch's shared memory (bytes): the staging and, when the block owns
// every window (one group), its lists, which alias the staging. The
// wrapper's smem_bytes (kernels/knn_capped.py) is the same.
template <int CV>
size_t smem_bytes(int qb, int G, int jt, int nbuf, int n_win, int cap, bool one_group) {
  const size_t XS4 = row_stride4<CV>();
  const size_t staging =
      CV > 8 ? 16 * (qb + kTileRows) * XS4 + 4 * kTileRows + 4 * (size_t)qb * kKeyStride
             : (size_t)nbuf * jt * G * (16 * XS4 + 4);
  const size_t lists = one_group ? 4 * (size_t)qb * n_win * (cap + 1) : 0;
  return staging > lists ? staging : lists;
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)limit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int CAP, int CV>
cudaError_t launch(const float* x, const float* q, const float* cnorm, const float* qnorm,
                   int* out, int* glists, const int* pred, int B, int N, int M, int K,
                   int n_pad, int window, int idx_bits, int qb, int G, int jt, int nbuf,
                   cudaStream_t stream) {
  if (window < 1 || n_pad % window) return cudaErrorInvalidValue;
  const int n_win = n_pad / window;
  const int groups = (n_win + G - 1) / G;
  constexpr bool kTwoPhase = CV > 8;
  if (G < 1 || G > kMaxGroup || (groups > 1) != (glists != nullptr)) return cudaErrorInvalidValue;
  if (kTwoPhase ? (qb != 64 && qb != 32) || jt != kTileRows / G || nbuf != 1
                : qb < kQM || qb % kQM || qb / kQM * G > 256 || jt < 1 ||
                      (nbuf != 1 && nbuf != 2))
    return cudaErrorInvalidValue;
  if (B == 0 || M == 0) return cudaSuccess;
  const size_t smem = smem_bytes<CV>(qb, G, jt, nbuf, n_win, CAP, groups == 1);
  const dim3 grid((M + qb - 1) / qb, B, groups);
  cudaError_t err;
  if constexpr (kTwoPhase) {
    auto kernel = knn_capped_kernel_tiled<CAP, CV>;
    err = set_smem((const void*)kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, qb / 8 * 32, smem, stream>>>(x, q, cnorm, qnorm, out, glists, pred, N, M,
                                                K, n_pad, n_win, window, idx_bits, G);
  } else {
    auto kernel = knn_capped_kernel_fused<CAP, CV>;
    err = set_smem((const void*)kernel, smem);
    if (err != cudaSuccess) return err;
    const int threads = (qb / kQM * G + 31) / 32 * 32;
    kernel<<<grid, threads, smem, stream>>>(x, q, cnorm, qnorm, out, glists, pred, N, M, K,
                                            n_pad, n_win, window, idx_bits, qb, G, jt, nbuf);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return err;
  const size_t msmem = 4 * (size_t)kMergeQueries * n_win * (n_win <= 64 ? CAP + 1 : CAP);
  auto merge = knn_capped_kernel_merge<CAP>;
  err = set_smem((const void*)merge, msmem);
  if (err != cudaSuccess) return err;
  merge<<<dim3((M + kMergeQueries - 1) / kMergeQueries, B), 32 * kMergeQueries, msmem,
          stream>>>(glists, out, pred, M, K, n_pad, n_win, idx_bits);
  return cudaGetLastError();
}

template <int CAP>
cudaError_t launch_cv(int cv, const float* x, const float* q, const float* cnorm,
                      const float* qnorm, int* out, int* glists, const int* pred, int B,
                      int N, int M, int K, int n_pad, int window, int idx_bits, int qb,
                      int G, int jt, int nbuf, cudaStream_t s) {
  switch (cv) {
    case 4: return launch<CAP, 4>(x, q, cnorm, qnorm, out, glists, pred, B, N, M, K, n_pad, window, idx_bits, qb, G, jt, nbuf, s);
    case 8: return launch<CAP, 8>(x, q, cnorm, qnorm, out, glists, pred, B, N, M, K, n_pad, window, idx_bits, qb, G, jt, nbuf, s);
    case 16: return launch<CAP, 16>(x, q, cnorm, qnorm, out, glists, pred, B, N, M, K, n_pad, window, idx_bits, qb, G, jt, nbuf, s);
    case 32: return launch<CAP, 32>(x, q, cnorm, qnorm, out, glists, pred, B, N, M, K, n_pad, window, idx_bits, qb, G, jt, nbuf, s);
    case 64: return launch<CAP, 64>(x, q, cnorm, qnorm, out, glists, pred, B, N, M, K, n_pad, window, idx_bits, qb, G, jt, nbuf, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B,N,cv), q (B,M,cv) with cv in {4,8,16,32,64} (zero-padded channels);
// cnorm (B,N), qnorm (B,M); out (B,M,K) int32; lists the (B,M,n_win,cap)
// int32 buffer of a split launch (more than one group of g windows), else
// null; pred a device int32 or null. qb (queries per block), g (windows
// per block), jt (j-steps per staged tile) and nbuf (tile buffers): the
// wrapper's launch_geometry. Returns a cudaError_t.
extern "C" int dgcnn_knn_capped(const float* x, const float* q,
                                const float* cnorm, const float* qnorm,
                                int* out, int* lists, const int* pred, int B, int N,
                                int M, int cv, int K,
                                int n_pad, int window, int cap, int idx_bits,
                                int qb, int g, int jt, int nbuf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cap) {
    case 4: return launch_cv<4>(cv, x, q, cnorm, qnorm, out, lists, pred, B, N, M, K, n_pad, window, idx_bits, qb, g, jt, nbuf, s);
    case 8: return launch_cv<8>(cv, x, q, cnorm, qnorm, out, lists, pred, B, N, M, K, n_pad, window, idx_bits, qb, g, jt, nbuf, s);
    default: return cudaErrorInvalidValue;
  }
}

// Message for a cudaError_t returned by any launcher of this library.
extern "C" const char* dgcnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
