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
// indices and writes (B, N, C) + (B, N) (~54 MB). The adds are reductions
// served by L2, where the (B, N, C) output (14 MB at C=64) stays resident;
// at C=4 their count, not the bytes, sets the pace (below).
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
// `tail`: one warp per query; the
// warp's lanes hold the query's u, w and argmax slots for their channels
// (c = lane + 32 * i, so loads and atomics coalesce) and walk the k slots,
// adding (am == j ? u : 0) + w into the target row; lane 0 adds the count;
// one FP32 atomic per (row, channel): B*N*k*C = 108 M at the production
// shape.
// Indices are clamped to [0, N), where the forward gather reads them, so a
// gradient goes to the row that the forward read and an out-of-range
// padding index (an overflowing capped window) never writes out of bounds.
//
// An optional device predicate `pred` (int32, may be null): when it reads 0
// every block returns at once (see knn_banded.cu); the output keeps the
// wrapper's zeros.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kThreads = 256;
constexpr int kTailWarps = kThreads / kLanes;
constexpr int kMaxCPerLane = 4;  // tail: C <= 128
constexpr int kMaxY = 65535;      // gridDim.y limit: the batch loop strides past it

// rows: slots per thread, 4 where a slot is a whole row (C=4), else 2
constexpr int kMaxRows = 4;
template <int G>
__host__ __device__ constexpr int rows_per_thread() { return G == 1 ? kMaxRows : 2; }

__device__ __forceinline__ int clamp_row(int t, int n) { return min(max(t, 0), n - 1); }

// one reduction per slot: a 16-byte slot is one vector reduction (sm_90's
// atomicAdd(float4*, float4); its result unused, it compiles to a RED)
__device__ __forceinline__ void red_add(float* dst, float v) { atomicAdd(dst, v); }
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

// u, w (B, N, C) float32, am (B, N, C) int8, idx (B, N, K) int32; out
// (B, N, C) and cnt (B, N) float32 zeroed by the caller; C <= 128.
// Returns a cudaError_t.
extern "C" int dgcnn_scatter_stage_tail(const float* u, const float* w, const int8_t* am,
                                        const int* idx, float* out, float* cnt,
                                        const int* pred, int B, int N, int K, int C,
                                        void* stream) {
  if (C > kLanes * kMaxCPerLane) return cudaErrorInvalidValue;
  const long long queries = (long long)B * N;
  scatter_tail_kernel<<<grid_for(queries, kTailWarps), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      u, w, am, idx, out, cnt, pred, B, N, K, C);
  return cudaGetLastError();
}
