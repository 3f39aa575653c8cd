// Banded FP32-exact k-nearest-neighbour selection for Hopper (sm_90a): the
// parity mode's kernel.
//
// Replaces dgcnn_tpu/kernels/knn_pallas.py::_knn_kernel_exact_banded
// (launched from _knn_exact_jit). Self-kNN: query tile t (qt queries)
// scores only the `band` rows [start, start + band), start being
// _band_starts' 128-aligned row for the tile (band = n_pad, the whole
// padded table, makes every start 0). It computes exactly what the TPU
// kernel computes:
//
//   score(q, o) = 2 * <q, x_o> - |x_o|^2   (knn_common.cuh: bit for bit the
//                                           flat exact kernel's score)
//   key         = order-exact monotone int32 of the score (no quantization,
//                 no index bits); rows o >= N (padding) score -inf
//   per window w = { in-band row r : r % n_win == w } keep the top-`cap`
//   (key, row) pairs, larger key first, then the LOWER row (lax.top_k's
//   order); a window with fewer than `cap` rows fills its last slots with
//   (INT_MIN, its first row), as the TPU kernel's knocked-out extractions;
//   merge the n_win * cap winners to the top-k in the same order.
//
// Beside the indices it writes each query's k-th winner key (`kth`, for the
// caller's band-edge certificate) and `ovf` = (max over windows of the
// window's cap-th key) >= kth: such a window may hide a row that ranks
// before the k-th winner, so the caller re-solves that query exactly.
//
// What bounds it on the H100: C FP32 FMAs per (query, in-band row below
// N) pair, so at full width B*N*N*C (50.2 G FLOP at B=8, N=7000, C=64:
// 0.749 ms at 67 TFLOP/s) and at band 2048 about B*N*2048*C (0.92 G FLOP
// at C=4), plus per pair the key and the insertion into the window's
// (key, row) list, a compare and four selects per slot, which at C=4 is
// most of the work. No tensor-core work (FP32 policy: the score must be
// the flat kernel's, bit for bit).
//
// Bit-equality. Every dot is one fmaf chain over channels 0..CV-1 from
// 0.f, then the explicitly rounded x2 and subtraction (knn_common.cuh's
// arithmetic: the fused kernel calls its knn_score, the two-phase kernel
// writes it out over the 8 x 8 dot tile), so the keys are
// the replaced kernel's and the flat exact kernel's bit for bit. Keys
// repeat, so the order is the pair (key, row): each window's list sees its
// rows in ascending order (one thread owns it for the whole band), so a
// candidate passes only entries of a strictly smaller key and the list
// stays in (key desc, row asc) order; the merge compares (key, row)
// lexicographically. The three outputs are therefore functions of the keys
// alone: the replaced kernel's (one query per lane) on every input, floats
// included.
//
// Design: the two kernels of knn_banded.cu. Window w is the residue class
// r % n_win, so the j-step rows j * n_win + s, s < 64, hold one candidate
// of each window (slots past n_win hold none). Tiles of j-steps arrive by
// cp.async (16 bytes a thread, zero-filled past N) into rows of an odd
// float4 stride. Each (query, window) list of (key, row) pairs stays in
// the registers of one thread for the whole band, filled branch-free (a
// key that beats no entry changes nothing; each slot computed from the old
// list, so that a thread's lists' insertions overlap).
//
// * C >= 16, the two-phase kernel (stages 2-3: C=64, full width): a block
//   owns 32 queries and 256 threads and walks the band in tiles of 8
//   j-steps (512 rows); the next tile's copy overlaps phase B. Phase A:
//   each thread computes the 8 x 8 dots of queries ty + 4a and tile rows
//   tx + 64c (tile_dots: two channels a read, every float from shared
//   memory feeding 4 FMAs) and writes their keys to a key tile. Phase B:
//   thread t owns window slot t % 64 of queries t / 64 + 4i, i < 8, and
//   inserts the tile's keys of its 8 lists.
// * C <= 8, the fused kernel (stage 1: C=4, band 2048): the dot is a few
//   FMAs and the insertion most of the work, so there is no key tile. A
//   block owns 16 queries and 256 threads, two blocks an SM; thread t owns
//   window slot s = t % 64 of queries t / 64 + 4a, a < 4 (the queries in
//   registers), scores each j-step's row s against them with the flat
//   kernel's knn_score and inserts the keys itself; tiles of 16 j-steps,
//   double-buffered.
//
// Query tiles are multiples of 32 rows, so a block's queries share one
// band start. `banded` is read on the device, so the geometry (fixed by
// the width) serves both widths of one launch. After the band the lists go
// to shared memory (aliasing the staging: keys, and rows as uint16) and
// merge_lists_lex (knn_select.cuh) pops each query's winners: per round a
// warp max over the heads' keys, then a warp min over the rows of the
// heads holding that key; two or four queries a warp, interleaved.
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.8; the build log beside the
// library): the two-phase cap-8 instances 254 registers, no spill (an
// unroll of 2 in the dot loop spills 8 bytes, 4 spills 276), 216,576 bytes
// of shared memory at C=64 (32 queries; the lists, 110,592 bytes at cap 8,
// alias it), one block of 8 warps per SM; the fused cap-8 instances 112
// registers at C=4 and 126 at C=8 (128 allowed: two blocks an SM), no
// spill, 55,296 bytes at C=4 (the lists of 16 queries at 64 windows).
// `cuobjdump -sass`: FFMA, no HMMA or GMMA, in every instance.
//
// `banded` (device int32, may be null): when it reads 0 the kernel scans
// the full padded table (band = n_pad), so one launch serves both branches
// of the wrapper's sortedness test; qt only moves the band starts, and at
// full width every start is 0. `pred` (device int32, may be null): when it
// reads 0 every block returns at once.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "knn_common.cuh"  // score_key, band_start, cp.async helpers
#include "knn_select.cuh"  // the dot tile, the (key, row) lists and merge

namespace {

constexpr int kSlots = 64;     // slots of a j-step: one row of each window
constexpr int kThreads = 256;
constexpr int kQB = 32;        // two-phase kernel: queries of a block
constexpr int kTY = 4;         // phase A: query rows ty + 4a ...
constexpr int kTX = 64;        // ... by tile rows tx + 64c
constexpr int kTileRows = 8 * kTX;          // 512: 8 j-steps
constexpr int kJT = kTileRows / kSlots;     // j-steps of a tile
constexpr int kKeyStride = kTileRows + 8;   // the key tile's row, in ints
constexpr int kLists = kQB * kSlots / kThreads;  // phase B: lists a thread
// phase A: 2-channel steps of the dot loop unrolled; more hoists loads
// while the 8 lists (128 registers at cap 8) are live, and spills (2: 8
// bytes, 4: 276 bytes at C >= 8, cap 8)
constexpr int kDotUnroll = 1;
// fused kernel (C <= 8): queries of a block, of a thread (one window slot
// a thread), j-steps of a tile (two buffers)
constexpr int kFQB = 16;
constexpr int kFQM = 4;
constexpr int kFThreads = kFQB * kSlots / kFQM;  // 256
constexpr int kFJT = 16;
constexpr int kFTileRows = kFJT * kSlots;        // 1024

// The band rows of j-steps [j0, j0 + JT) (row j * n_win + s at tile row
// (j - j0) * 64 + s), with their norms, by cp.async into `dst` / `dn`,
// zero-filled where the j-step is past the window, the slot past n_win or
// the row past N; then commits.
template <int CV, int JT>
__device__ __forceinline__ void stage_rows(float4* dst, float* dn, const float* xb,
                                           const float* cb, int j0, int start, int n_win,
                                           int w_sz, int N) {
  constexpr int V = CV / 4, XS4 = row_stride4<CV>(), ROWS = JT * kSlots;
  for (int i = threadIdx.x; i < ROWS * V; i += blockDim.x) {
    const int row = i / V, c4 = i % V;
    const int j = j0 + row / kSlots, s = row % kSlots;
    const int o = start + j * n_win + s;
    const bool ok = j < w_sz && s < n_win && o < N;
    cp_async16(dst + row * XS4 + c4, ok ? xb + (size_t)o * CV + 4 * c4 : xb, ok);
  }
  for (int row = threadIdx.x; row < ROWS; row += blockDim.x) {
    const int j = j0 + row / kSlots, s = row % kSlots;
    const int o = start + j * n_win + s;
    const bool ok = j < w_sz && s < n_win && o < N;
    cp_async4(dn + row, ok ? cb + o : cb, ok);
  }
  cp_async_commit();
}

// A launch's shared memory (bytes): the staging or, if larger, the lists
// that alias it (keys as int32 and rows as uint16, cap + 1 slots a list).
// The staging of the two-phase kernel (C >= 16): the queries, one tile of
// 512 rows, their norms, the key tile; of the fused kernel (C <= 8): two
// tiles of 1024 rows and their norms. The wrapper's smem_bytes
// (kernels/knn_exact_banded.py) is the same.
size_t smem_bytes(int cv, int n_win, int cap) {
  const size_t xs4 = (cv / 4) % 2 ? cv / 4 : cv / 4 + 1;
  const bool fused = cv <= 8;
  const size_t staging =
      fused ? 2 * (size_t)kFTileRows * (16 * xs4 + 4)
            : 16 * (kQB + kTileRows) * xs4 + 4 * kTileRows + 4 * (size_t)kQB * kKeyStride;
  const size_t lists = 6 * (size_t)(fused ? kFQB : kQB) * n_win * (cap + 1);
  return staging > lists ? staging : lists;
}

// Phase A of one tile: the 8 x 8 dots of queries ty + 4a and tile rows tx
// + 64c, their scores and keys into the key tile [32][kKeyStride]. CHECK:
// the tile holds padding rows (o >= N: score -inf). Keys of slots past
// n_win or j-steps past the window are written but never read.
template <int CV, bool CHECK>
__device__ __forceinline__ void tile_keys(const float4* __restrict__ qs4,
                                          const float4* __restrict__ xs4,
                                          const float* __restrict__ xn, int* __restrict__ keys,
                                          int ty, int tx, int j0, int start, int N, int n_win) {
  float acc[8][8];
  tile_dots<CV, kTX, kDotUnroll>(acc, qs4, xs4, ty, kTY, tx);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int row = tx + kTX * c;
    const int r = (j0 + row / kSlots) * n_win + row % kSlots;
    const float xnv = xn[row];
    const bool pad = CHECK && start + r >= N;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float sc = __fsub_rn(__fmul_rn(2.f, acc[a][c]), xnv);  // knn_score's roundings
      if (pad) sc = -INFINITY;
      keys[(ty + kTY * a) * kKeyStride + row] = score_key(sc);
    }
  }
}

template <int CAP, int CV>
__global__ void __launch_bounds__(kThreads, 1)
knn_exact_banded_kernel(const float* __restrict__ x,      // (B, N, CV)
                        const float* __restrict__ cnorm,  // (B, N)
                        int* __restrict__ out,            // (B, N, K)
                        int* __restrict__ kth,            // (B, N)
                        int* __restrict__ ovf,            // (B, N)
                        const int* __restrict__ pred,     // () or null
                        const int* __restrict__ banded,   // () or null
                        int N, int K, int n_pad, int band, int n_win, int qt) {
  if (pred != nullptr && *pred == 0) return;
  if (banded != nullptr && *banded == 0) band = n_pad;  // full width
  constexpr int XS4 = row_stride4<CV>();
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // phase A: a warp is 4 query rows by 8 consecutive tile rows
  const int tx = warp * 8 + (lane & 7), ty = lane >> 3;
  // phase B: window slot pw of queries pq + 4i
  const int pw = tid % kSlots, pq = tid / kSlots;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQB;
  const int start = band_start(q0 / qt, qt, n_pad, band);
  const int w_sz = band / n_win;  // rows per window
  const int tiles = (w_sz + kJT - 1) / kJT;

  // staging: [queries 32 x XS4] [tile 512 x XS4] [norms 512] [keys 32 x
  // kKeyStride]; after the band the lists alias it: keys [32][n_win][CAP
  // + 1], then rows [32][n_win][CAP + 1] as uint16
  float4* qs4 = smem4;
  float4* xs4 = qs4 + kQB * XS4;
  float* xn = reinterpret_cast<float*>(xs4 + kTileRows * XS4);
  int* keys = reinterpret_cast<int*>(xn + kTileRows);
  int* lkeys = reinterpret_cast<int*>(smem4);
  unsigned short* lrows = reinterpret_cast<unsigned short*>(lkeys + kQB * n_win * (CAP + 1));

  const float* xb = x + (size_t)b * N * CV;
  const float* cb = cnorm + (size_t)b * N;
  stage_queries<CV>(qs4, xb, q0, kQB, N);  // committed with tile 0
  int tk[kLists][CAP], ts[kLists][CAP];  // keys, in-window rows s (r = s * n_win + w)
#pragma unroll
  for (int i = 0; i < kLists; ++i)
#pragma unroll
    for (int c = 0; c < CAP; ++c) {
      tk[i][c] = INT_MIN;
      ts[i][c] = 0;
    }

  stage_rows<CV, kJT>(xs4, xn, xb, cb, 0, start, n_win, w_sz, N);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // the tile has arrived; phase B of the last one is done
    const int j0 = t * kJT, jn = min(kJT, w_sz - j0);
    if (start + (j0 + jn) * n_win > N) {  // the tile's last band row is padding
      tile_keys<CV, true>(qs4, xs4, xn, keys, ty, tx, j0, start, N, n_win);
    } else {
      tile_keys<CV, false>(qs4, xs4, xn, keys, ty, tx, j0, start, N, n_win);
    }
    __syncthreads();  // the keys are written; the tile is free
    if (t + 1 < tiles) stage_rows<CV, kJT>(xs4, xn, xb, cb, j0 + kJT, start, n_win, w_sz, N);
    if (pw < n_win) {
      for (int jj = 0; jj < jn; ++jj) {
        const int* kj = keys + pq * kKeyStride + jj * kSlots + pw;
#pragma unroll
        for (int i = 0; i < kLists; ++i) {
          // branch-free: the 8 lists' insertions interleave
          insert_pair<CAP>(tk[i], ts[i], kj[4 * i * kKeyStride], j0 + jj);
        }
      }
    }
  }
  __syncthreads();  // every phase B has read the keys: the lists alias them
  if (pw < n_win) {
#pragma unroll
    for (int i = 0; i < kLists; ++i) {
      const int l = ((pq + 4 * i) * n_win + pw) * (CAP + 1);
#pragma unroll
      for (int c = 0; c < CAP; ++c) {
        lkeys[l + c] = tk[i][c];
        lrows[l + c] = static_cast<unsigned short>(ts[i][c]);
      }
      lkeys[l + CAP] = INT_MIN;
      lrows[l + CAP] = 0;
    }
  }
  __syncthreads();
  merge_lists_lex<CAP, kQB / 8>(lkeys, lrows, q0, b, N, K, n_win, start, out, kth, ovf);
}

// Fused kernel, one tile's j-steps [j0, j0 + jn): thread slot s scores row
// j * n_win + s of each against its kFQM queries and inserts the keys into
// its lists, j ascending (the window's rows in order). CHECK: the tile
// holds padding rows (o >= N: score -inf).
template <int CAP, int CV, bool CHECK>
__device__ __forceinline__ void fused_tile(int (&tk)[kFQM][CAP], int (&ts)[kFQM][CAP],
                                           const float (&qv)[kFQM][CV],
                                           const float4* __restrict__ xt,
                                           const float* __restrict__ nt, int s, int j0,
                                           int jn, int start, int N, int n_win) {
  constexpr int XS4 = row_stride4<CV>();
  // two j-steps' loads and insertions overlap at C=4 (at C=8 the queries'
  // registers leave no room: 126 of 128 without it)
#pragma unroll (CV <= 4 ? 2 : 1)
  for (int jj = 0; jj < jn; ++jj) {
    const int row = jj * kSlots + s;
    const float* xr = reinterpret_cast<const float*>(xt + row * XS4);
    const float xnv = nt[row];
    const bool pad = CHECK && start + (j0 + jj) * n_win + s >= N;
#pragma unroll
    for (int a = 0; a < kFQM; ++a) {
      float sc = knn_score<CV, false>(qv[a], xr, xnv);
      if (pad) sc = -INFINITY;
      insert_pair<CAP>(tk[a], ts[a], score_key(sc), j0 + jj);
    }
  }
}

template <int CAP, int CV>
__global__ void __launch_bounds__(kFThreads, 512 / kFThreads)
knn_exact_banded_fused(const float* __restrict__ x,      // (B, N, CV)
                       const float* __restrict__ cnorm,  // (B, N)
                       int* __restrict__ out,            // (B, N, K)
                       int* __restrict__ kth,            // (B, N)
                       int* __restrict__ ovf,            // (B, N)
                       const int* __restrict__ pred,     // () or null
                       const int* __restrict__ banded,   // () or null
                       int N, int K, int n_pad, int band, int n_win, int qt) {
  if (pred != nullptr && *pred == 0) return;
  if (banded != nullptr && *banded == 0) band = n_pad;  // full width
  constexpr int XS4 = row_stride4<CV>(), TQ = kFQB / kFQM;
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a warp is 8 consecutive window slots by 4 query columns
  const int s = warp % 8 * 8 + (lane & 7), tq = warp / 8 * 4 + (lane >> 3);
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kFQB;
  const int start = band_start(q0 / qt, qt, n_pad, band);
  const int w_sz = band / n_win;  // rows per window
  const int tiles = (w_sz + kFJT - 1) / kFJT;

  // staging: [2 tiles x 1024 x XS4] [2 x 1024 norms]; after the band the
  // lists alias it: keys [16][n_win][CAP + 1], then rows as uint16
  float4* xs4 = smem4;
  float* xn = reinterpret_cast<float*>(xs4 + 2 * kFTileRows * XS4);
  int* lkeys = reinterpret_cast<int*>(smem4);
  unsigned short* lrows = reinterpret_cast<unsigned short*>(lkeys + kFQB * n_win * (CAP + 1));

  const float* xb = x + (size_t)b * N * CV;
  const float* cb = cnorm + (size_t)b * N;
  float qv[kFQM][CV];
  int tk[kFQM][CAP], ts[kFQM][CAP];  // keys, in-window rows j (r = j * n_win + s)
#pragma unroll
  for (int a = 0; a < kFQM; ++a) {
    load_query<CV>(qv[a], xb + (size_t)min(q0 + tq + TQ * a, N - 1) * CV);
#pragma unroll
    for (int c = 0; c < CAP; ++c) {
      tk[a][c] = INT_MIN;
      ts[a][c] = 0;
    }
  }

  stage_rows<CV, kFJT>(xs4, xn, xb, cb, 0, start, n_win, w_sz, N);
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      stage_rows<CV, kFJT>(xs4 + (buf ^ 1) * kFTileRows * XS4, xn + (buf ^ 1) * kFTileRows,
                           xb, cb, (t + 1) * kFJT, start, n_win, w_sz, N);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t has arrived
    const int j0 = t * kFJT, jn = min(kFJT, w_sz - j0);
    if (s < n_win) {
      const float4* xt = xs4 + buf * kFTileRows * XS4;
      const float* nt = xn + buf * kFTileRows;
      if (start + (j0 + jn) * n_win > N) {  // the tile's last band row is padding
        fused_tile<CAP, CV, true>(tk, ts, qv, xt, nt, s, j0, jn, start, N, n_win);
      } else {
        fused_tile<CAP, CV, false>(tk, ts, qv, xt, nt, s, j0, jn, start, N, n_win);
      }
    }
    __syncthreads();  // every thread is done with the buffer the next copy fills
  }
  if (s < n_win) {  // past the last barrier: the staging is free
#pragma unroll
    for (int a = 0; a < kFQM; ++a) {
      const int l = ((tq + TQ * a) * n_win + s) * (CAP + 1);
#pragma unroll
      for (int c = 0; c < CAP; ++c) {
        lkeys[l + c] = tk[a][c];
        lrows[l + c] = static_cast<unsigned short>(ts[a][c]);
      }
      lkeys[l + CAP] = INT_MIN;
      lrows[l + CAP] = 0;
    }
  }
  __syncthreads();
  merge_lists_lex<CAP, kFQB / (kFThreads / 32)>(lkeys, lrows, q0, b, N, K, n_win, start, out,
                                                 kth, ovf);
}

template <int CAP, int CV>
cudaError_t launch(const float* x, const float* cnorm, int* out, int* kth,
                   int* ovf, const int* pred, const int* banded, int B, int N,
                   int K, int n_pad, int band, int n_win, int qt,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(CV, n_win, CAP);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)limit) return cudaErrorInvalidValue;
  constexpr int qb = CV <= 8 ? kFQB : kQB, threads = CV <= 8 ? kFThreads : kThreads;
  const dim3 grid((N + qb - 1) / qb, B);
  if constexpr (CV <= 8) {  // the fused kernel
    auto kernel = knn_exact_banded_fused<CAP, CV>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, smem, stream>>>(x, cnorm, out, kth, ovf, pred, banded, N, K, n_pad,
                                            band, n_win, qt);
  } else {  // the two-phase kernel
    auto kernel = knn_exact_banded_kernel<CAP, CV>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, smem, stream>>>(x, cnorm, out, kth, ovf, pred, banded, N, K, n_pad,
                                            band, n_win, qt);
  }
  return cudaGetLastError();
}

template <int CAP>
cudaError_t launch_cv(int cv, const float* x, const float* cnorm, int* out,
                      int* kth, int* ovf, const int* pred, const int* banded,
                      int B, int N, int K, int n_pad, int band, int n_win,
                      int qt, cudaStream_t s) {
  switch (cv) {
    case 4: return launch<CAP, 4>(x, cnorm, out, kth, ovf, pred, banded, B, N, K, n_pad, band, n_win, qt, s);
    case 8: return launch<CAP, 8>(x, cnorm, out, kth, ovf, pred, banded, B, N, K, n_pad, band, n_win, qt, s);
    case 16: return launch<CAP, 16>(x, cnorm, out, kth, ovf, pred, banded, B, N, K, n_pad, band, n_win, qt, s);
    case 32: return launch<CAP, 32>(x, cnorm, out, kth, ovf, pred, banded, B, N, K, n_pad, band, n_win, qt, s);
    case 64: return launch<CAP, 64>(x, cnorm, out, kth, ovf, pred, banded, B, N, K, n_pad, band, n_win, qt, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B,N,cv) with cv in {4,8,16,32,64} (zero-padded channels), cnorm (B,N);
// out (B,N,K), kth (B,N), ovf (B,N) int32; pred and banded device int32s or
// null. qt is a multiple of 32; n_pad >= band >= K; band % n_win == 0;
// band / n_win <= 65536; n_win <= 64; n_win * cap >= K. Returns a
// cudaError_t.
extern "C" int dgcnn_knn_exact_banded(const float* x, const float* cnorm,
                                      int* out, int* kth, int* ovf,
                                      const int* pred, const int* banded,
                                      int B, int N, int cv, int K, int n_pad,
                                      int band, int n_win, int cap, int qt,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_win < 1 || n_win > kSlots || qt < kQB || qt % kQB || band % n_win ||
      band / n_win > 65536 ||
      (banded != nullptr && (n_pad % n_win || n_pad / n_win > 65536)))
    return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  switch (cap) {
    case 4: return launch_cv<4>(cv, x, cnorm, out, kth, ovf, pred, banded, B, N, K, n_pad, band, n_win, qt, s);
    case 8: return launch_cv<8>(cv, x, cnorm, out, kth, ovf, pred, banded, B, N, K, n_pad, band, n_win, qt, s);
    default: return cudaErrorInvalidValue;
  }
}
