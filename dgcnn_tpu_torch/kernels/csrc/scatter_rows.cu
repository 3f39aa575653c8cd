// Row scatter-adds of the EdgeConv training backward, for Hopper (sm_90a).
//
// Replaces dgcnn_tpu/kernels/scatter_pallas.py::_kernel (launched by
// scatter_add_rows) and ::_stage_tail_kernel (scatter_stage_tail_rows):
//
//   rows   out[b, idx[b,m]] += dy[b, m]                     (the gather VJP
//                                                           of stages 1-2)
//   tail   out[b, idx[b,q,j]] += u[b,q] * (am[b,q] == j) + w[b,q]
//          cnt[b, idx[b,q,j]] += 1                         (stage 3's fused
//                                                           BN + max tail)
//
// The tail's (B, N, k, C) cotangent is never written to device memory: each
// row is computed from the query's (B, N, C) tables as it is added, which
// is the point of the TPU kernel too. The count comes out as its own
// (B, N) array, not in a reserved lane of a 128-wide padded table (a TPU
// tiling artifact).
//
// What bounds them on the H100: bytes. `rows` reads dy once (B*M*C*4: 430
// MB at B=8, M=N*k=210000, C=64; 26.9 MB at C=4) and the (B, M) indices
// (6.7 MB) and writes (B, N, C): 0.135 ms at C=64, 0.010 ms at C=4, at
// 3.35 TB/s. `tail` reads only the (B, N, C) tables, the (B, N, k)
// indices and writes (B, N, C) + (B, N) (~54 MB: 0.016 ms); its B*N*k*C
// adds (107.5 M at B=8, N=7000, k=30, C=64) are what it has to get
// through (below). `rows`' adds are reductions served by L2, where the
// (B, N, C) output (14 MB at C=64) stays resident; at C=4 their count, not
// the bytes, sets the pace (below).
//
// Design. On the TPU the whole (N, C) accumulator sits in VMEM and a
// sequential grid carries it from chunk to chunk. Hopper's blocks run in
// no order, so the carry becomes atomics into an output the wrapper zeroes:
// the sum order then changes from run to run (FP32 results differ in the
// last bits; a train step is not bit-reproducible).
//
// `rows`: a 2-D grid, blockIdx.y the batch element, whose base pointers
// are formed once in 64 bits; inside an element every offset is a 32-bit
// int (the launcher refuses M*C or N*C >= 2^31), and the element's dy is a
// run of M*G 16-byte slots (G = C/4). G is a template parameter for the
// widths the port runs (G=1 at C=4, G=16 at C=64), so slot -> (row,
// group) is a shift; other widths take a generic instance (a 32-bit
// division). Each thread takes R slots a block width apart (loads
// coalesce) and issues their R index loads (read-only path) and R dy loads
// (evict-first: dy is read once and must not push the output out of L2),
// then R reductions: R=4 at C=4, four rows in flight per thread; R=2 at
// C=64, where 16 neighbouring lanes share a row (a broadcast index load).
// Each 16-byte slot is added by one vector reduction (sm_90's float4
// atomicAdd): 1.68 M reductions at C=4 and 26.9 M at C=64, a quarter of
// the scalar atomics the same adds take. C % 4 != 0, or a dy or output pointer that is not
// 16-byte aligned, takes the same kernel on 4-byte slots with scalar
// atomics. At C=4 the reductions land on random 16-byte rows, one L2
// request each, and their rate (~60 G/s), not the bytes, sets the pace:
// 2 or 4 rows per thread, or read-only against evict-first index loads,
// moved it by 5% at most; at C=64 a warp's reductions cover whole
// 256-byte rows and the kernel runs at 57% of its byte bound.
// `cuobjdump -sass` of the built library (nvcc 12.8, sm_90a): each of the
// three float4 instances holds one REDG.E.ADD.F32x4.FTZ.RN.STRONG.GPU per
// slot, scalar REDG.E.ADD.F32 appear only in the 4-byte instance and the
// tail; the G=1 and G=16 instances hold no division sequence, the generic
// ones a 32-bit one (I2F.RP / MUFU.RCP), none a 64-bit one. Measured with
// scripts/torch_row_kernels.py on an H100 80GB HBM3 at 700 W (B=8,
// M=210000, 50 launches queued per pair of events, with the zeroing of
// the output): 0.0307 ms at C=4 and 0.2370 ms at C=64 on kNN-of-blocks
// indices (0.0297 and 0.2366 on uniform ones), against 0.053 and 0.800 ms
// for zeros + index_add_.
//
// `tail`: the TPU kernel keeps one element's whole (N, C) accumulator in
// VMEM across its query chunks, so its adds never leave the core. The first
// design here (kept as the global route) gives each query a warp and
// adds every (row, channel) by a scalar global reduction: B*N*k*C = 107.5 M
// FP32 reductions through L2 at the production shape (B=8, N=7000, k=30,
// C=64), 0.167-0.175 ms against a byte bound of 0.016 ms (H100 80GB HBM3,
// 700 W): ~620 G scalar reductions a second, 2.5 TB/s of adds. The card
// takes float4 reductions on the same indices at 3.15 TB/s (0.137 ms for
// the 107.5 M adds: chip_smoke.py's DIAG_REDUCTION_RATE), but a
// warp-per-query kernel adding float4 slots read 0.178 ms. A channel
// slice of the accumulator in shared memory (the TPU kernel's resident
// accumulator cut by channels) lost at every slice width: Hopper has no
// native shared FP32 add, so each add compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN), 0.35-0.58 ms.
//
// The tile route (qt > 0, N <= 32768) cuts the reductions instead: stage
// 3's neighbours are local (a banded kNN in feature space over x-sorted
// points), so the k entries of a tile of neighbouring queries fall on fewer
// distinct rows than entries (0.49 of them at 68 queries, 0.32 at 136, on
// a production train step's stage 3). A block owns a tile of qt queries of
// one element (qt * k <= 8192 entries, contiguous in idx, as are the
// tile's table rows) and stages the tile's u and w rows and argmax slots
// in shared memory, then sorts its entries by target row by counting: the
// rows' span from a block min / max, a histogram of the span with native
// int shared atomics (each entry keeps its rank among its row's entries),
// an exclusive scan, then each entry to its place. Each half-warp walks an
// equal slice of the sorted entries with its 16 lanes over the channels
// (four a lane where C % 4 == 0 and the tables and output are aligned, else
// two or one), summing a row's entries, (am == j ? u : 0) + w, in
// registers (kTileBatch entries' loads issued before their adds), and adds
// the sum into the zeroed output by one vector reduction a lane where the
// row changes (a row two slices share is added twice), with the run's
// length into the count. No float atomic touches shared memory, and L2
// takes one reduction per distinct (row, channel) of a tile in place of one
// per entry. What holds it is the walk (patched builds of
// scripts/exp_scatter_tail_variants.py, 68 queries: staging 0.009 ms, the
// sort 0.016, the walk 0.07-0.08, its reductions ~0.02), at about twice the
// shared-memory wavefronts its loads take. Tried and lost (H100 80GB HBM3,
// 700 W, the train step's stage 3): entries' u and w read through L1 (0.187
// ms), u routed apart by its own scalar reductions (0.136-0.140), u read
// only where a slot matches (0.125), one entry a warp at two channels a
// lane (0.158), tiles of 34 / 136 / 273 queries, 8- and 32-warp blocks.
//
// The global route (qt = 0: N past the tile's 15-bit rows, or a tile past
// shared memory) is the first design; the wrapper chooses the route and
// the tile from the shape (kernels/scatter_rows.py::tail_plan), not on
// failure.
//
// Indices are clamped to [0, N), where the forward gather reads them, so a
// gradient goes to the row that the forward read and an out-of-range
// padding index (an overflowing capped window) never writes out of bounds.
//
// An optional device predicate `pred` (int32, may be null): when it reads 0
// every block returns at once (see knn_banded.cu); the outputs keep the
// wrapper's zeros.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kThreads = 256;
constexpr int kTailWarps = kThreads / kLanes;
constexpr int kMaxY = 65535;      // gridDim.y limit: the batch loop strides past it

// rows: slots per thread, 4 where a slot is a whole row (C=4), else 2
constexpr int kMaxRows = 4;
template <int G>
__host__ __device__ constexpr int rows_per_thread() { return G == 1 ? kMaxRows : 2; }

__device__ __forceinline__ int clamp_row(int t, int n) { return min(max(t, 0), n - 1); }

// one reduction per slot: a 16-byte slot is one vector reduction (sm_90's
// atomicAdd(float4*, float4); its result unused, it compiles to a RED)
__device__ __forceinline__ void red_add(float* dst, float v) { atomicAdd(dst, v); }
__device__ __forceinline__ void red_add(float2* dst, float2 v) { atomicAdd(dst, v); }
__device__ __forceinline__ void red_add(float4* dst, float4 v) { atomicAdd(dst, v); }

// T: float4 (16-byte slots) or float (4-byte slots); G: slots per row, 0
// for the run-time width g
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const T* __restrict__ dy,    // (B, M, g) slots
                    const int* __restrict__ idx,  // (B, M)
                    T* __restrict__ out,          // (B, N, g) slots, zeroed
                    const int* __restrict__ pred,
                    int B, int M, int N, int g_rt) {
  if (pred != nullptr && *pred == 0) return;
  constexpr int R = rows_per_thread<G>();
  const int g = G > 0 ? G : g_rt;
  const int total = M * g;
  const int s0 = blockIdx.x * (kThreads * R) + threadIdx.x;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const T* db = dy + (size_t)b * M * g;
    const int* ib = idx + (size_t)b * M;
    T* ob = out + (size_t)b * N * g;
    int dst[R];
    T v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = s0 + r * kThreads;
      if (s < total) {
        dst[r] = clamp_row(__ldg(ib + s / g), N) * g + s % g;
        v[r] = __ldcs(db + s);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (s0 + r * kThreads < total) red_add(ob + dst[r], v[r]);
  }
}

// `tail`, the global route: the first design, one warp per query;
// the warp's lanes hold the query's u, w and argmax slots for their
// channels (c = lane + 32 * i, so loads and reductions coalesce) and walk
// the k slots, adding (am == j ? u : 0) + w into the target row; lane 0
// adds the count. C <= 128.
constexpr int kMaxCPerLane = 4;

__global__ void __launch_bounds__(kThreads)
scatter_tail_kernel(const float* __restrict__ u,         // (B, N, C)
                    const float* __restrict__ w,         // (B, N, C)
                    const int8_t* __restrict__ am,       // (B, N, C) k-slot
                    const int* __restrict__ idx,         // (B, N, K)
                    float* __restrict__ out,             // (B, N, C), zeroed
                    float* __restrict__ cnt,             // (B, N), zeroed
                    const int* __restrict__ pred,
                    int B, int N, int K, int C) {
  if (pred != nullptr && *pred == 0) return;
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const long long total = (long long)B * N;
  for (long long q = (long long)blockIdx.x * kTailWarps + warp; q < total;
       q += (long long)gridDim.x * kTailWarps) {
    const long long b = q / N;
    float ur[kMaxCPerLane], wr[kMaxCPerLane];
    int ar[kMaxCPerLane];
#pragma unroll
    for (int i = 0; i < kMaxCPerLane; ++i) {
      const int c = lane + kLanes * i;
      const bool on = c < C;
      ur[i] = on ? u[q * C + c] : 0.f;
      wr[i] = on ? w[q * C + c] : 0.f;
      ar[i] = on ? (int)am[q * C + c] : -1;
    }
    const int* irow = idx + q * K;
    float* base = out + (size_t)b * N * C;
    for (int j0 = 0; j0 < K; j0 += kLanes) {
      const int mine = irow[min(j0 + lane, K - 1)];
      const int cnt_j = min(kLanes, K - j0);
      for (int jj = 0; jj < cnt_j; ++jj) {
        const int j = j0 + jj;
        const int target = clamp_row(__shfl_sync(0xffffffffu, mine, jj), N);
        float* dst = base + (size_t)target * C;
#pragma unroll
        for (int i = 0; i < kMaxCPerLane; ++i) {
          const int c = lane + kLanes * i;
          if (c < C) atomicAdd(dst + c, (ar[i] == j ? ur[i] : 0.f) + wr[i]);
        }
        if (lane == 0) atomicAdd(cnt + (size_t)b * N + target, 1.f);
      }
    }
  }
}

// `tail`, the tile route: see the design note above.
constexpr int kTileThreads = 512;
constexpr int kTileWarps = kTileThreads / kLanes;
constexpr int kTileMaxRows = 32768;  // N: the histogram of a tile's span, and 15 bits of row
constexpr int kTileMaxQueries = 512;  // qt: 9 bits of query
constexpr int kTileMaxEntries = 8192;  // qt * K

// The block's minimum (MIN) or maximum of v; `scratch` holds kTileWarps ints.
template <bool MIN>
__device__ __forceinline__ int block_extreme(int v, int* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MIN ? min(v, o) : max(v, o);
  }
  if (threadIdx.x % kLanes == 0) scratch[threadIdx.x / kLanes] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int i = 1; i < kTileWarps; ++i) v = MIN ? min(v, scratch[i]) : max(v, scratch[i]);
  __syncthreads();  // scratch is free again
  return v;
}

// a[0, n) -> its exclusive prefix sums, in place; `scratch` holds
// kTileWarps ints. Each thread sums a contiguous run of a, the warps scan
// the runs' sums, then each thread writes its run's prefixes.
__device__ __forceinline__ void block_exclusive_scan(int* a, int n, int* scratch) {
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int per = (n + kTileThreads - 1) / kTileThreads;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int incl = s;
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == kLanes - 1) scratch[warp] = incl;
  __syncthreads();
  int base = 0;
  for (int i = 0; i < warp; ++i) base += scratch[i];
  base += incl - s;
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = base;
    base += v;
  }
  __syncthreads();
}

// (am == j ? u : 0) + w over the V channels at c (V: float4, float2 or
// float), from the tile's rows in shared memory
__device__ __forceinline__ float4 entry_value(const float* us, const float* ws,
                                              const int8_t* as, int j, float4) {
  const float4 uv = *reinterpret_cast<const float4*>(us);
  const float4 wv = *reinterpret_cast<const float4*>(ws);
  const char4 a = *reinterpret_cast<const char4*>(as);
  return make_float4((a.x == j ? uv.x : 0.f) + wv.x, (a.y == j ? uv.y : 0.f) + wv.y,
                     (a.z == j ? uv.z : 0.f) + wv.z, (a.w == j ? uv.w : 0.f) + wv.w);
}
__device__ __forceinline__ float2 entry_value(const float* us, const float* ws,
                                              const int8_t* as, int j, float2) {
  const float2 uv = *reinterpret_cast<const float2*>(us);
  const float2 wv = *reinterpret_cast<const float2*>(ws);
  const char2 a = *reinterpret_cast<const char2*>(as);
  return make_float2((a.x == j ? uv.x : 0.f) + wv.x, (a.y == j ? uv.y : 0.f) + wv.y);
}
__device__ __forceinline__ float entry_value(const float* us, const float* ws,
                                             const int8_t* as, int j, float) {
  return ((int)*as == j ? *us : 0.f) + *ws;
}
__device__ __forceinline__ void add_to(float4& acc, float4 v) {
  acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
}
__device__ __forceinline__ void add_to(float2& acc, float2 v) { acc.x += v.x, acc.y += v.y; }
__device__ __forceinline__ void add_to(float& acc, float v) { acc += v; }

constexpr int kTileBatch = 4;  // sorted entries a half-warp loads before it adds them
constexpr int kTileSlices = 2 * kTileWarps;  // a half-warp's slice of the sorted entries

// The tile kernel's shared memory: the histogram of N rows and two int
// arrays of qt * K entries, then (16-byte aligned) the tile's u and w rows
// and its argmax slots, qt * C of each (kernels/scatter_rows.py::
// tile_smem_bytes).
__host__ __device__ inline size_t tile_ints(int N, int K, int qt) {
  return ((size_t)N + 2 * (size_t)qt * K + 3) / 4 * 4;
}
size_t tile_smem_bytes(int N, int K, int C, int qt) {
  return sizeof(int) * tile_ints(N, K, qt) + (2 * sizeof(float) + 1) * (size_t)qt * C;
}

// Grid (ceil(N / qt), min(B, 65535)), kTileThreads threads, tile_smem_bytes.
template <typename V>
__global__ void __launch_bounds__(kTileThreads, 1024 / kTileThreads)
scatter_tail_tile_kernel(const float* __restrict__ u,    // (B, N, C)
                         const float* __restrict__ w,    // (B, N, C)
                         const int8_t* __restrict__ am,  // (B, N, C) k-slot
                         const int* __restrict__ idx,    // (B, N, K)
                         float* __restrict__ out,        // (B, N, C), zeroed
                         float* __restrict__ cnt,        // (B, N), zeroed
                         const int* __restrict__ pred,
                         int B, int N, int K, int C, int qt) {
  if (pred != nullptr && *pred == 0) return;
  constexpr int VW = sizeof(V) / sizeof(float);
  extern __shared__ int smem[];
  __shared__ int scratch[kTileWarps];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int q0 = blockIdx.x * qt, qn = min(qt, N - q0), E = qn * K;  // the tile's entries
  int* hist = smem;              // [N]: the span's rows' counts, then their offsets
  int* rank = hist + N;          // [qt * K]: an entry's place among its row's entries
  int* sorted = rank + qt * K;   // [qt * K]: (row - lo) << 16 | q_local << 7 | j, by row
  float* us = reinterpret_cast<float*>(smem + tile_ints(N, K, qt));  // [qt][C]
  float* ws = us + (size_t)qt * C;                                     // [qt][C]
  int8_t* as = reinterpret_cast<int8_t*>(ws + (size_t)qt * C);        // [qt][C]
  // per step of kTileThreads entries, a thread's query advances by dq, its slot by dj
  const int dq = kTileThreads / K, dj = kTileThreads % K;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const size_t base = (size_t)b * N;
    const int* ib = idx + (base + q0) * K;  // the tile's entries are contiguous, ...
    const float* ug = u + (base + q0) * C;  // ... and so are its table rows
    const float* wg = w + (base + q0) * C;
    const int8_t* ag = am + (base + q0) * C;
    if constexpr (VW == 4) {  // 16-byte copies (the launcher checks the alignment)
      for (int i = threadIdx.x; i < qn * C / 4; i += kTileThreads) {
        reinterpret_cast<float4*>(us)[i] = __ldg(reinterpret_cast<const float4*>(ug) + i);
        reinterpret_cast<float4*>(ws)[i] = __ldg(reinterpret_cast<const float4*>(wg) + i);
        reinterpret_cast<char4*>(as)[i] = __ldg(reinterpret_cast<const char4*>(ag) + i);
      }
    } else {
      for (int i = threadIdx.x; i < qn * C; i += kTileThreads) {
        us[i] = __ldg(ug + i);
        ws[i] = __ldg(wg + i);
        as[i] = __ldg(ag + i);
      }
    }
    int lo = INT_MAX, hi = INT_MIN;
    for (int e = threadIdx.x; e < E; e += kTileThreads) {
      const int t = clamp_row(__ldg(ib + e), N);
      lo = min(lo, t);
      hi = max(hi, t);
    }
    lo = block_extreme<true>(lo, scratch);
    hi = block_extreme<false>(hi, scratch);
    const int span = hi - lo + 1;
    for (int r = threadIdx.x; r < span; r += kTileThreads) hist[r] = 0;
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += kTileThreads)  // native int shared atomics
      rank[e] = atomicAdd(hist + clamp_row(__ldg(ib + e), N) - lo, 1);
    __syncthreads();
    block_exclusive_scan(hist, span, scratch);
    {
      int q = threadIdx.x / K, j = threadIdx.x % K;
      for (int e = threadIdx.x; e < E; e += kTileThreads) {
        const int r = clamp_row(__ldg(ib + e), N) - lo;
        sorted[hist[r] + rank[e]] = r << 16 | q << 7 | j;
        q += dq;
        j += dj;
        if (j >= K) j -= K, ++q;
      }
    }
    __syncthreads();
    // each half-warp walks an equal slice of the sorted entries, its 16
    // lanes over the channels, summing a row's entries in registers and
    // adding the sum into the output where the row changes (a row whose
    // entries two slices share is added twice)
    const int half = lane / 16, hl = lane % 16;
    const int per = (E + kTileSlices - 1) / kTileSlices;
    const int p0 = min(E, (2 * warp + half) * per), p1 = min(E, p0 + per);
    for (int c0 = 0; c0 < C; c0 += 16 * VW) {
      const int c = c0 + hl * VW;
      const bool on = c < C, counts = hl == 0 && c0 == 0;
      int cur = -1, run = 0;
      V acc{};
      for (int p = p0; p < p1; p += kTileBatch) {
        int rows[kTileBatch];
        V vals[kTileBatch];
#pragma unroll
        for (int i = 0; i < kTileBatch; ++i) {  // the batch's loads, then its adds
          rows[i] = -1;
          vals[i] = V{};
          if (p + i < p1) {
            const int v = sorted[p + i];
            rows[i] = v >> 16;
            const int o = ((v >> 7) & (kTileMaxQueries - 1)) * C + c;
            if (on) vals[i] = entry_value(us + o, ws + o, as + o, v & 127, V{});
          }
        }
#pragma unroll
        for (int i = 0; i < kTileBatch; ++i) {
          if (rows[i] < 0) continue;
          if (rows[i] != cur) {
            if (cur >= 0) {
              if (on) red_add(reinterpret_cast<V*>(out + (base + lo + cur) * C + c), acc);
              if (counts) atomicAdd(cnt + base + lo + cur, (float)run);
            }
            cur = rows[i], run = 0, acc = V{};
          }
          ++run;
          add_to(acc, vals[i]);
        }
      }
      if (cur >= 0) {
        if (on) red_add(reinterpret_cast<V*>(out + (base + lo + cur) * C + c), acc);
        if (counts) atomicAdd(cnt + base + lo + cur, (float)run);
      }
    }
    __syncthreads();  // the shared arrays are read before the next element's
  }
}

unsigned grid_for(long long work, int per_block) {
  long long blocks = (work + per_block - 1) / per_block;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 blocks per SM
  return (unsigned)(blocks > 0 ? blocks : 1);
}

template <typename T, int G>
int launch_rows(const float* dy, const int* idx, float* out, const int* pred, int B, int M,
                int N, int g, cudaStream_t s) {
  constexpr int per_block = kThreads * rows_per_thread<G>();
  const dim3 grid((unsigned)((M * g + per_block - 1) / per_block), (unsigned)min(B, kMaxY));
  scatter_rows_kernel<T, G><<<grid, kThreads, 0, s>>>(
      reinterpret_cast<const T*>(dy), idx, reinterpret_cast<T*>(out), pred, B, M, N, g);
  return cudaGetLastError();
}

template <typename V>
int launch_tail_tile(const float* u, const float* w, const int8_t* am, const int* idx,
                     float* out, float* cnt, const int* pred, int B, int N, int K, int C,
                     int qt, cudaStream_t s) {
  const size_t smem = tile_smem_bytes(N, K, C, qt);
  auto kernel = scatter_tail_tile_kernel<V>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);  // two tiles an SM
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N + qt - 1) / qt), (unsigned)min(B, kMaxY));
  kernel<<<grid, kTileThreads, smem, s>>>(u, w, am, idx, out, cnt, pred, B, N, K, C, qt);
  return cudaGetLastError();
}

}  // namespace

// dy (B, M, C) float32, idx (B, M) int32, out (B, N, C) float32 zeroed by
// the caller, all contiguous; M*C and N*C below 2^31. The 16-byte path
// needs C % 4 == 0 and 16-byte aligned dy and out. Returns a cudaError_t.
extern "C" int dgcnn_scatter_add_rows(const float* dy, const int* idx, float* out,
                                      const int* pred, int B, int M, int N, int C,
                                      void* stream) {
  if (B < 0 || M < 0 || N < 0 || C < 1) return cudaErrorInvalidValue;
  if ((long long)M * C > INT_MAX - kThreads * kMaxRows || (long long)N * C > INT_MAX)
    return cudaErrorInvalidValue;
  if (B == 0 || M == 0) return cudaSuccess;
  if (N == 0) return cudaErrorInvalidValue;  // rows to add, nowhere to add them
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!vec4) return launch_rows<float, 0>(dy, idx, out, pred, B, M, N, C, s);
  switch (C / 4) {
    case 1: return launch_rows<float4, 1>(dy, idx, out, pred, B, M, N, 1, s);
    case 16: return launch_rows<float4, 16>(dy, idx, out, pred, B, M, N, 16, s);
    default: return launch_rows<float4, 0>(dy, idx, out, pred, B, M, N, C / 4, s);
  }
}

// u, w (B, N, C) float32, am (B, N, C) int8, idx (B, N, K) int32, all
// contiguous; out (B, N, C) and cnt (B, N) float32 zeroed by the caller;
// 1 <= K <= 127. qt (queries a tile of the tile route, 1 <= qt <= 512,
// qt * K <= 8192, N <= 32768; 0 = the global route, C <= 128) as
// kernels/scatter_rows.py::tail_plan chooses it. Returns a cudaError_t.
extern "C" int dgcnn_scatter_stage_tail(const float* u, const float* w, const int8_t* am,
                                        const int* idx, float* out, float* cnt,
                                        const int* pred, int B, int N, int K, int C, int qt,
                                        void* stream) {
  if (B < 0 || N < 0 || K < 1 || K > 127 || C < 1 || (long long)N * C > INT_MAX)
    return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qt == 0) {
    if (C > kLanes * kMaxCPerLane) return cudaErrorInvalidValue;
    scatter_tail_kernel<<<grid_for((long long)B * N, kTailWarps), kThreads, 0, s>>>(
        u, w, am, idx, out, cnt, pred, B, N, K, C);
    return cudaGetLastError();
  }
  if (qt < 0 || qt > kTileMaxQueries || qt * K > kTileMaxEntries || N > kTileMaxRows)
    return cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (tile_smem_bytes(N, K, C, qt) > (size_t)limit) return cudaErrorInvalidValue;
  auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  if (C % 4 == 0 && o % 16 == 0 && aligned(u, 16) && aligned(w, 16) && aligned(am, 4))
    return launch_tail_tile<float4>(u, w, am, idx, out, cnt, pred, B, N, K, C, qt, s);
  if (C % 2 == 0 && o % 8 == 0)
    return launch_tail_tile<float2>(u, w, am, idx, out, cnt, pred, B, N, K, C, qt, s);
  return launch_tail_tile<float>(u, w, am, idx, out, cnt, pred, B, N, K, C, qt, s);
}
