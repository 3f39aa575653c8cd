// Packed-key k-nearest-neighbour selection for Hopper (sm_90a): the flat
// kernel and the split one.
//
// The flat kernel replaces dgcnn_tpu/kernels/knn_pallas.py::
// _knn_kernel_packed (launched from _knn_pallas_jit through
// knn_pallas(packed=True, cap=0), with or without `queries`). It computes
// exactly what that kernel computes:
//
//   score(q, o) = (2 * <q, x_o> - |x_o|^2) - |q|^2   (knn_select.cuh's
//                                                     score, FMA dot)
//   key         = monotone_int(score) >> 1, low idx_bits replaced by
//                 (n_pad - 1 - o), n_pad = N rounded up to 128, idx_bits =
//                 max(13, bit length of n_pad - 1) <= 15
//   the k largest keys, largest first: keys are unique, so the order is
//   fully determined (score ties go to the lower row).
//
// The padding rows N <= o < n_pad of the TPU kernel score -inf and rank
// behind every real row: they never enter a list.
//
// What bounds it on the H100: B*M*N*C FP32 FMAs (25.1 G at B=8, N=M=7000,
// C=64: 50.2 G FLOP, 0.75 ms at the FP32 peak), plus per pair the score's
// two subtractions, the key and one compare against a running k-th key.
// No tensor-core work (FP32 policy).
//
// Bit-equality. Every dot is one fmaf chain over channels 0..CV-1 from
// 0.f, then the two explicitly rounded subtractions; the keys are unique
// per query (their low bits), so the top-k is a function of the keys
// alone, whatever order the rows are scored in and however they are split
// among threads: this kernel returns the indices of the kernel it replaced
// (one query per lane) on every input, floats included.
//
// Design. A block owns qb queries (64; 32 for a small C <= 8 grid), 8 a
// warp, and walks the table in tiles of rows by cp.async (16 bytes a
// thread, zero-filled past N) into rows of an odd float4 stride, the tiles
// from the queries' own rows outward (their tile, then alternately one
// further on each side: on x-sorted points the near rows come first and
// the k-th key is nearly final after a tile or two). Each query's
// top-KMAX keys (KMAX >= k) lie across its warp's lanes, slot s in lane s
// % 32 (KMAX / 32 registers a lane), sorted. The warp takes a query's keys
// of a tile 32 at a time, one a lane: one ballot keeps those above the
// query's k-th key so far (the k-th largest key of the rows seen is at
// most the final one, so a key below it cannot be in the top-k: the
// filter is exact), and each survivor goes into the list by a ballot of
// the slots above it (its position), a shuffle that moves the slots below
// it down one lane, and a select; the warp's queries take one survivor
// each a round, so that their insertions overlap, and read their k-th
// keys once a batch. The selection, the work of the kernel it replaced at
// C=4 (32-slot register lists filled per lane and slice), falls to one
// compare a candidate and a few shuffles for each of the ~k ln(N / k)
// keys that beat the running k-th. After the table each lane writes its
// slots of the top-k.
//
// * C >= 16, the two-phase kernel (the packed forward's stages 2-3): 256
//   threads and 64 queries a block (32 were 4.5% slower on the H100 at
//   C=64: the variant pk_qb32 of scripts/exp_knn_third_path_variants.py),
//   tiles of 256 rows; phase A: each thread computes the 8 x 8 dots of 8
//   queries and 8 rows (tile_dots: two channels a read, every float from
//   shared memory feeding 4 FMAs) into a key tile; phase B: the warps'
//   selection from the key tile, while the next tile's copy is in flight.
// * C <= 8, the fused kernel (stage 1): the dot is a few FMAs and the
//   key's integer steps are most of the work, so the warps keep their
//   queries in registers and each lane scores its row itself, tiles of
//   256 rows double-buffered; a score below the float that its query's
//   k-th key starts at (score_bound) is dropped before its key is made.
//
// The TPU kernel's wrapped-subtract extraction (one max-reduce per step
// over the resident (qt, n_pad) key tile) is a vector-unit device and is
// not replayed.
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.8; the build log beside the
// library): the two-phase KMAX-32 C=64 instance 240 registers, no spill,
// 155,648 bytes of shared memory, one block of 8 warps per SM; the fused
// KMAX-32 C=4 instances 76-80 registers (bounded to three blocks an SM),
// 10,240 bytes. No instance spills. `cuobjdump -sass`: FFMA, no HMMA or
// GMMA, in every instance.
//
// An optional device predicate `pred` (int32, may be null): when it reads
// 0 every block returns at once.

// The split kernel replaces knn_pallas.py::_knn_kernel_packed_split
// (knn_pallas(packed=True, splits=s) where n_pad <= 8192 and n_pad % s ==
// 0). Its keys differ from the flat kernel's: the monotone int is NOT
// shifted and a fixed 13-bit index field replaces the low bits,
//
//   key = (monotone_int(score) & ~0x1FFF) | (n_pad - 1 - o)
//
// so it keeps 19 bits of score where the flat kernel keeps 18, and the two
// select differently wherever two distances agree in 18 bits but not in
// 19. The TPU kernel cuts the candidate rows into `splits` slices, keeps
// each slice's top-k and merges them; the keys are unique, so its result
// is the top-k of the split keys over all N rows whatever the slicing, and
// the split kernel here is the flat kernel's bodies (the two-phase one at
// C >= 16, the fused one at C <= 8) on the split key: the template
// parameter SHIFT (1: the flat key, 0: the split key) picks the key, and
// the fused kernel's score_bound is derived for each (below). `splits`
// shapes no work: 64-query blocks fill the card at every shape the port
// runs (B=8: 128 blocks at 1000 queries). Bit-equal to the first split
// kernel (per-slice register lists, then a merge kernel over a
// (B, M, splits, K) scratch) on every input, floats included.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "knn_common.cuh"  // score_key, load_query, cp.async helpers
#include "knn_select.cuh"  // keys, lists, the dot tile, query staging

namespace {

constexpr int kThreads = 256;  // the two-phase kernel's block ...
constexpr int kQB = 64;        // ... and its queries, 8 a warp
constexpr int kTileRows = 64 * kThreads / kQB;  // rows a tile: 8 x 8 dots a thread
constexpr int kKeyStride = kTileRows + 8;       // the key tile's row, in ints (conflict-free)

constexpr int kFusedTileRows = 256;  // the fused kernel's (C <= 8) staged rows a tile

// The flat kernel's shared memory (bytes): at C >= 16 the queries, one tile
// and its norms, the key tile; at C <= 8 (the fused kernel) two tiles of
// 256 rows and their norms. The wrapper's smem_bytes (kernels/knn_packed.py)
// is the same.
size_t flat_smem_bytes(int cv) {
  const size_t xs4 = (cv / 4) % 2 ? cv / 4 : cv / 4 + 1;
  if (cv <= 8) return 2 * (size_t)kFusedTileRows * (16 * xs4 + 4);
  return 16 * (kQB + kTileRows) * xs4 + 4 * kTileRows + 4 * (size_t)kQB * kKeyStride;
}

// Tile t of rows [t * TR, t * TR + TR), with their norms, by cp.async,
// zero-filled past N; then commits.
template <int CV, int TR>
__device__ __forceinline__ void stage_tile(float4* dst, float* dn, const float* xb,
                                           const float* cb, int t, int N) {
  constexpr int V = CV / 4, XS4 = row_stride4<CV>();
  for (int i = threadIdx.x; i < TR * V; i += blockDim.x) {
    const int row = i / V, c4 = i % V;
    const int o = t * TR + row;
    cp_async16(dst + row * XS4 + c4, o < N ? xb + (size_t)o * CV + 4 * c4 : xb, o < N);
  }
  for (int row = threadIdx.x; row < TR; row += blockDim.x) {
    const int o = t * TR + row;
    cp_async4(dn + row, o < N ? cb + o : cb, o < N);
  }
  cp_async_commit();
}

// The packed key of a score: ((monotone_int(score) >> SHIFT) & keep_mask) |
// low; SHIFT 1 is knn_select.cuh's pack_key (the flat kernel), SHIFT 0 the
// split kernel's key.
template <int SHIFT>
__device__ __forceinline__ int key_of(float s, int low, int keep_mask) {
  return ((score_key(s) >> SHIFT) & keep_mask) | low;
}

// The i-th tile of the scan from tile t0 outward: t0, t0 + 1, t0 - 1, t0 +
// 2, ..., then the rest of the longer side, each of the `tiles` once.
__device__ __forceinline__ int outward(int i, int t0, int tiles) {
  const int lo = t0, hi = tiles - 1 - t0, m = min(lo, hi);
  if (i <= 2 * m) return (i & 1) ? t0 + (i + 1) / 2 : t0 - i / 2;
  return lo > hi ? t0 - (i - m) : t0 + (i - m);
}

// Phase A of one tile: the 8 x 8 dots of queries ty + TY * a and tile rows
// tx + TX * c, their packed keys into the key tile [kQB][kKeyStride]. CHECK: the
// tile holds padding rows (o >= N: INT_MIN, below every real key).
template <int CV, int SHIFT, bool CHECK>
__device__ __forceinline__ void tile_keys(const float4* __restrict__ qs4,
                                          const float4* __restrict__ xs4,
                                          const float* __restrict__ xn, const float (&qn)[8],
                                          int* __restrict__ keys, int ty, int tx, int o0,
                                          int n_pad, int N, int keep_mask) {
  constexpr int TY = kQB / 8, TX = kThreads / TY, KS = kKeyStride;
  float acc[8][8];
  tile_dots<CV, TX>(acc, qs4, xs4, ty, TY, tx);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int row = tx + TX * c;
    const int o = o0 + row;
    const float xnv = xn[row];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      int v = key_of<SHIFT>(score(acc[a][c], xnv, qn[a]), n_pad - 1 - o, keep_mask);
      if (CHECK && o >= N) v = INT_MIN;
      keys[(ty + TY * a) * KS + row] = v;
    }
  }
}

// A warp's sorted list of 32 * L unique keys, largest first, slot s in
// lane s % 32, register s / 32.
template <int L>
__device__ __forceinline__ int list_slot(const int (&lst)[L], int slot) {
  const int v = L == 1 || slot < 32 ? lst[0] : lst[L - 1];
  return __shfl_sync(0xffffffffu, v, slot & 31);
}

// c into the warp's list (keys unique): its position is the number of
// slots above it; the slots from there on move down one (the last drops).
// INT_MIN changes nothing: it lands on the first empty slot, or past the
// list.
template <int L>
__device__ __forceinline__ void list_insert(int (&lst)[L], int c, int lane) {
  int pos = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) pos += __popc(__ballot_sync(0xffffffffu, lst[l] > c));
  int carry = 0;  // the slot above lane 0 of register l: lane 31 of register l - 1
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int up = __shfl_up_sync(0xffffffffu, lst[l], 1);
    const int last = __shfl_sync(0xffffffffu, lst[l], 31);
    const int slot = lane + 32 * l;
    const int moved = lane == 0 ? carry : up;
    lst[l] = slot < pos ? lst[l] : (slot == pos ? c : moved);
    carry = last;
  }
}

// The survivors `pass` of one batch (a key a lane, `v`) of each of the
// warp's QW queries into their lists, in rounds of one survivor a query:
// the queries' insertions are independent of each other and branch-free
// (a query with none left inserts INT_MIN, which changes nothing; a
// survivor that has fallen below the k-th key since its ballot lands past
// slot k - 1, which is never read, or past the list: KMAX >= k); then
// each query's k-th key, read once.
template <int QW, int L>
__device__ __forceinline__ void insert_batch(int (&lst)[QW][L], int (&kth)[QW],
                                             const int (&v)[QW], unsigned (&pass)[QW],
                                             int lane, int K) {
  unsigned any;
  do {
    any = 0;
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      const int c = __shfl_sync(0xffffffffu, v[qi], (__ffs(pass[qi]) - 1) & 31);
      list_insert<L>(lst[qi], pass[qi] ? c : INT_MIN, lane);
      pass[qi] &= pass[qi] - 1;
      any |= pass[qi];
    }
  } while (any);  // warp-uniform
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) kth[qi] = list_slot<L>(lst[qi], K - 1);
}

// Each lane's slots of the warp's queries' top-k (queries qw0 + qi), as
// row indices n_pad - 1 - (key & imask); queries past M skipped.
template <int QW, int L>
__device__ __forceinline__ void write_lists(const int (&lst)[QW][L], int* __restrict__ out,
                                            int b, int M, int K, int qw0, int n_pad,
                                            int imask, int lane) {
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int slot = lane + 32 * l;
      if (qw0 + qi < M && slot < K)
        out[((size_t)b * M + qw0 + qi) * K + slot] = n_pad - 1 - (lst[qi][l] & imask);
    }
  }
}

// The two-phase kernel (C >= 16): kQB queries a block, 8 a warp.
template <int KMAX, int CV, int SHIFT>
__global__ void __launch_bounds__(kThreads, 1)
knn_packed_kernel(const float* __restrict__ x,      // (B, N, CV)
                  const float* __restrict__ q,      // (B, M, CV)
                  const float* __restrict__ cnorm,  // (B, N)
                  const float* __restrict__ qnorm,  // (B, M)
                  int* __restrict__ out,            // (B, M, K)
                  const int* __restrict__ pred,     // () or null
                  int N, int M, int K, int n_pad, int idx_bits) {
  if (pred != nullptr && *pred == 0) return;
  constexpr int XS4 = row_stride4<CV>();
  constexpr int TY = kQB / 8, TX = kThreads / TY, TR = kTileRows;
  constexpr int KS = kKeyStride, QW = kQB / 8, L = KMAX / 32;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // phase A: a warp is 4 query rows by 8 consecutive tile rows
  const int tx = (warp % (TX / 8)) * 8 + (lane & 7);
  const int ty = (warp / (TX / 8)) * 4 + (lane >> 3);
  const int b = blockIdx.y, q0 = blockIdx.x * kQB;
  const int tiles = (N + TR - 1) / TR;
  const int keep_mask = ~((1 << idx_bits) - 1);

  // [queries kQB x XS4] [tile TR x XS4] [norms TR] [keys kQB x KS]
  float4* qs4 = smem4;
  float4* xs4 = qs4 + kQB * XS4;
  float* xn = reinterpret_cast<float*>(xs4 + TR * XS4);
  int* keys = reinterpret_cast<int*>(xn + TR);

  const float* xb = x + (size_t)b * N * CV;
  const float* cb = cnorm + (size_t)b * N;
  float qn[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) qn[a] = qnorm[(size_t)b * M + min(q0 + ty + TY * a, M - 1)];
  stage_queries<CV>(qs4, q + (size_t)b * M * CV, q0, kQB, M);  // committed with tile 0
  // the tile of the rows the block's queries sit at (self-kNN), else of
  // the same share of the table
  const int t0 = min(tiles - 1, (int)(((long long)q0 + kQB / 2) * N / M / TR));
  int lst[QW][L], kth[QW];  // the warp's queries' lists; their k-th keys so far
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    kth[i] = INT_MIN;  // below every real key
#pragma unroll
    for (int l = 0; l < L; ++l) lst[i][l] = INT_MIN;
  }

  stage_tile<CV, TR>(xs4, xn, xb, cb, outward(0, t0, tiles), N);
  for (int i = 0; i < tiles; ++i) {
    const int t = outward(i, t0, tiles);
    cp_async_wait<0>();
    __syncthreads();  // the tile has arrived; phase B of the last one is done
    if ((t + 1) * TR > N) {
      tile_keys<CV, SHIFT, true>(qs4, xs4, xn, qn, keys, ty, tx, t * TR, n_pad, N, keep_mask);
    } else {
      tile_keys<CV, SHIFT, false>(qs4, xs4, xn, qn, keys, ty, tx, t * TR, n_pad, N, keep_mask);
    }
    __syncthreads();  // the keys are written; the tile is free
    if (i + 1 < tiles) stage_tile<CV, TR>(xs4, xn, xb, cb, outward(i + 1, t0, tiles), N);
    for (int j = 0; j < TR; j += 32) {
      int v[QW];
      unsigned pass[QW], any = 0;
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) {
        v[qi] = keys[(warp * QW + qi) * KS + j + lane];
        pass[qi] = __ballot_sync(0xffffffffu, v[qi] > kth[qi]);
        any |= pass[qi];
      }
      if (any) insert_batch<QW, L>(lst, kth, v, pass, lane, K);  // warp-uniform
    }
  }
  write_lists<QW, L>(lst, out, b, M, K, q0 + warp * QW, n_pad, (1 << idx_bits) - 1, lane);
}

// The least score whose packed key's score bits reach those of `kth`, as
// a float: a score below it has a key below kth, so the fused kernel drops
// it before making its key (exact: the k-th key so far is at most the
// final one). key = ((m >> SHIFT) & keep) | low, m the score's monotone
// int, and hi = kth & keep has its low bits clear, so (m >> SHIFT) & keep
// < hi exactly where m < hi << SHIFT: the bound is the float whose
// monotone int is hi << SHIFT. -inf while the list is not full or where hi
// << SHIFT has no float counterpart; a NaN bound (hi in the NaN range)
// rejects nothing, and a NaN score passes every bound.
// kernels/knn_packed.py::score_bound computes the same.
template <int SHIFT>
__device__ __forceinline__ float score_bound(int kth, int keep_mask) {
  const int hi = kth & keep_mask;
  if (kth == INT_MIN || hi <= (SHIFT ? -0x3fffffff : INT_MIN)) return -INFINITY;
  const int m = hi * (1 << SHIFT);
  return __int_as_float(m >= 0 ? m : (int)(0x80000000u | (unsigned)(-m)));
}

// The flat kernel at C <= 8, fused: qb / 8 warps of 8 queries each, the
// queries in registers. Tiles of kFusedTileRows rows (from the block's own
// outward) are staged by cp.async, double-buffered; a warp takes a tile
// 32 rows at a time, one a lane, and each lane scores its row against the
// warp's 8 queries (the same fmaf chain as tile_dots). A score below its
// query's score_bound is dropped before its key is made; the keys of the
// rest are held against the k-th key by a ballot, and the survivors go
// into the lists in rounds, as in the two-phase kernel.
// (Unbounded, ptxas gave the C=4, k <= 32 instance of one key 80 registers
// and of the other 101, which one changing with unrelated edits to the
// source: 101 leaves two blocks an SM in place of three, 13-17% slower.
// Their bound asks for three.)
template <int KMAX, int CV, int SHIFT>
__global__ void __launch_bounds__(kThreads, KMAX == 32 && CV == 4 ? 3 : 1)
knn_packed_kernel_fused(const float* __restrict__ x,      // (B, N, CV)
                        const float* __restrict__ q,      // (B, M, CV)
                        const float* __restrict__ cnorm,  // (B, N)
                        const float* __restrict__ qnorm,  // (B, M)
                        int* __restrict__ out,            // (B, M, K)
                        const int* __restrict__ pred,     // () or null
                        int N, int M, int K, int n_pad, int idx_bits) {
  if (pred != nullptr && *pred == 0) return;
  constexpr int XS4 = row_stride4<CV>(), V = CV / 4, QW = 8, L = KMAX / 32;
  constexpr int TR = kFusedTileRows;
  extern __shared__ float4 smem4[];
  float4* xs4 = smem4;                                       // [2][TR][XS4]
  float* xn = reinterpret_cast<float*>(xs4 + 2 * TR * XS4);  // [2][TR]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qb = blockDim.x / 32 * QW;
  const int b = blockIdx.y, q0 = blockIdx.x * qb;
  const int tiles = (N + TR - 1) / TR;
  const int keep_mask = ~((1 << idx_bits) - 1);
  const float* xb = x + (size_t)b * N * CV;
  const float* cb = cnorm + (size_t)b * N;

  float qv[QW][CV], qn[QW];
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
    const int qq = min(q0 + warp * QW + qi, M - 1);
    load_query<CV>(qv[qi], q + ((size_t)b * M + qq) * CV);
    qn[qi] = qnorm[(size_t)b * M + qq];
  }
  const int t0 = min(tiles - 1, (int)(((long long)q0 + qb / 2) * N / M / TR));
  int lst[QW][L], kth[QW];
  float sb[QW];  // score_bound of kth
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
    kth[qi] = INT_MIN;
    sb[qi] = -INFINITY;
#pragma unroll
    for (int l = 0; l < L; ++l) lst[qi][l] = INT_MIN;
  }

  stage_tile<CV, TR>(xs4, xn, xb, cb, outward(0, t0, tiles), N);
  for (int i = 0; i < tiles; ++i) {
    const int t = outward(i, t0, tiles), buf = i & 1;
    if (i + 1 < tiles) {
      stage_tile<CV, TR>(xs4 + (buf ^ 1) * TR * XS4, xn + (buf ^ 1) * TR, xb, cb,
                         outward(i + 1, t0, tiles), N);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i has arrived
    const float4* xt = xs4 + buf * TR * XS4;
    for (int j = 0; j < TR; j += 32) {
      const int row = j + lane, o = t * TR + row;
      float xr[CV];
#pragma unroll
      for (int c4 = 0; c4 < V; ++c4) {
        const float4 f = xt[row * XS4 + c4];
        xr[4 * c4] = f.x;
        xr[4 * c4 + 1] = f.y;
        xr[4 * c4 + 2] = f.z;
        xr[4 * c4 + 3] = f.w;
      }
      const float xnv = xn[buf * TR + row];
      int v[QW];
      unsigned pass[QW], any = 0;
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < CV; ++c) dot = fmaf(qv[qi][c], xr[c], dot);
        const float sc = score(dot, xnv, qn[qi]);
        pass[qi] = __ballot_sync(0xffffffffu, o < N && !(sc < sb[qi]));
        v[qi] = INT_MIN;
        if (pass[qi]) {  // warp-uniform: a key only where a row may pass
          v[qi] = key_of<SHIFT>(sc, n_pad - 1 - o, keep_mask);
          pass[qi] = __ballot_sync(0xffffffffu, o < N && v[qi] > kth[qi]);
        }
        any |= pass[qi];
      }
      if (!any) continue;  // warp-uniform
      insert_batch<QW, L>(lst, kth, v, pass, lane, K);
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) sb[qi] = score_bound<SHIFT>(kth[qi], keep_mask);
    }
    __syncthreads();  // every warp is done with the buffer the next copy fills
  }
  write_lists<QW, L>(lst, out, b, M, K, q0 + warp * QW, n_pad, (1 << idx_bits) - 1, lane);
}

// qb: queries a block of the fused kernel (64 or 32); the two-phase one
// takes kQB. SHIFT: 1 the flat key, 0 the split key (idx_bits 13).
template <int KMAX, int CV, int SHIFT>
cudaError_t launch_flat(const float* x, const float* q, const float* cnorm,
                        const float* qnorm, int* out, const int* pred, int B, int N,
                        int M, int K, int n_pad, int idx_bits, int qb, cudaStream_t stream) {
  const size_t smem = flat_smem_bytes(CV);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)limit) return cudaErrorInvalidValue;
  if constexpr (CV <= 8) {
    const dim3 grid((M + qb - 1) / qb, B);
    auto kernel = knn_packed_kernel_fused<KMAX, CV, SHIFT>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, qb / 8 * 32, smem, stream>>>(x, q, cnorm, qnorm, out, pred, N, M, K, n_pad,
                                                idx_bits);
  } else {
    if (qb != kQB) return cudaErrorInvalidValue;
    const dim3 grid((M + kQB - 1) / kQB, B);
    auto kernel = knn_packed_kernel<KMAX, CV, SHIFT>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(x, q, cnorm, qnorm, out, pred, N, M, K, n_pad,
                                              idx_bits);
  }
  return cudaGetLastError();
}

template <int KMAX, int SHIFT>
cudaError_t launch_flat_cv(int cv, const float* x, const float* q, const float* cnorm,
                           const float* qnorm, int* out, const int* pred, int B, int N,
                           int M, int K, int n_pad, int idx_bits, int qb, cudaStream_t s) {
  switch (cv) {
    case 4: return launch_flat<KMAX, 4, SHIFT>(x, q, cnorm, qnorm, out, pred, B, N, M, K, n_pad, idx_bits, qb, s);
    case 8: return launch_flat<KMAX, 8, SHIFT>(x, q, cnorm, qnorm, out, pred, B, N, M, K, n_pad, idx_bits, qb, s);
    case 16: return launch_flat<KMAX, 16, SHIFT>(x, q, cnorm, qnorm, out, pred, B, N, M, K, n_pad, idx_bits, qb, s);
    case 32: return launch_flat<KMAX, 32, SHIFT>(x, q, cnorm, qnorm, out, pred, B, N, M, K, n_pad, idx_bits, qb, s);
    case 64: return launch_flat<KMAX, 64, SHIFT>(x, q, cnorm, qnorm, out, pred, B, N, M, K, n_pad, idx_bits, qb, s);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int kLanes = 32;
constexpr int kSplitIdxBits = 13;  // the split key's index field (n_pad <= 8192)

// Both entry points: 1 <= K <= 64, K <= N, qb 64 or 32.
template <int SHIFT>
int launch_packed(const float* x, const float* q, const float* cnorm, const float* qnorm,
                  int* out, const int* pred, int B, int N, int M, int cv, int K, int n_pad,
                  int idx_bits, int qb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > 2 * kLanes || K > N || (qb != 64 && qb != 32)) return cudaErrorInvalidValue;
  if (B == 0 || M == 0) return cudaSuccess;
  return K <= kLanes
             ? launch_flat_cv<kLanes, SHIFT>(cv, x, q, cnorm, qnorm, out, pred, B, N, M, K, n_pad, idx_bits, qb, s)
             : launch_flat_cv<2 * kLanes, SHIFT>(cv, x, q, cnorm, qnorm, out, pred, B, N, M, K, n_pad, idx_bits, qb, s);
}

}  // namespace

// x (B,N,cv), q (B,M,cv) with cv in {4,8,16,32,64} (zero-padded channels);
// cnorm (B,N), qnorm (B,M); out (B,M,K) int32 with 1 <= K <= 64 and K <= N;
// n_pad = N rounded up to 128, 13 <= idx_bits <= 15; pred a device int32 or
// null; qb (queries a block, the wrapper's launch_geometry): 64 or 32 at
// cv <= 8, 64 above. Returns a cudaError_t.
extern "C" int dgcnn_knn_packed(const float* x, const float* q,
                                const float* cnorm, const float* qnorm,
                                int* out, const int* pred, int B, int N, int M,
                                int cv, int K, int n_pad, int idx_bits, int qb,
                                void* stream) {
  return launch_packed<1>(x, q, cnorm, qnorm, out, pred, B, N, M, cv, K, n_pad, idx_bits, qb,
                          stream);
}

// The split kernel: as dgcnn_knn_packed on the split key, with n_pad <=
// 8192 (its 13 index bits). One launch on `stream`. Returns a cudaError_t.
extern "C" int dgcnn_knn_packed_split(const float* x, const float* q,
                                      const float* cnorm, const float* qnorm,
                                      int* out, const int* pred, int B, int N, int M,
                                      int cv, int K, int n_pad, int qb, void* stream) {
  if (n_pad > (1 << kSplitIdxBits)) return cudaErrorInvalidValue;
  return launch_packed<0>(x, q, cnorm, qnorm, out, pred, B, N, M, cv, K, n_pad, kSplitIdxBits,
                          qb, stream);
}
