// Packed-key k-nearest-neighbour selection for Hopper (sm_90a): the flat
// kernel and the split one.
//
// The flat kernel replaces dgcnn_tpu/kernels/knn_pallas.py::
// _knn_kernel_packed (launched from _knn_pallas_jit through
// knn_pallas(packed=True, cap=0), with or without `queries`). It computes
// exactly what that kernel computes:
//
//   score(q, o) = (2 * <q, x_o> - |x_o|^2) - |q|^2   (knn_common.cuh, then
//                                                     the recentring)
//   key         = monotone_int(score) >> 1, low idx_bits replaced by
//                 (n_pad - 1 - o), n_pad = N rounded up to 128, idx_bits =
//                 max(13, bit length of n_pad - 1) <= 15
//   the k largest keys, largest first: keys are unique, so the order is
//   fully determined (score ties go to the lower row).
//
// The padding rows N <= o < n_pad of the TPU kernel score -inf and rank
// behind every real row: they are not scanned.
//
// What bounds it on the H100: B*M*N*C FP32 FMAs (25.1 G at B=8, N=M=7000,
// C=64: 50.2 G FLOP, 0.75 ms at the FP32 peak) plus one compare per pair
// against a running k-th key. No tensor-core work (FP32 policy).
//
// Design: a block owns 32 queries, one per lane, held in registers, and
// its 8 warps split the rows into 8 interleaved slices (row o belongs to
// slice o % 8). The block stages runs of rows in shared memory, one row of
// every slice per step, so every lane of a warp reads the same candidate
// row (a broadcast, one float4 per four FMAs). Each lane keeps its slice's
// top-KMAX keys (KMAX >= k) in a sorted register list: a key enters only
// when it beats the last, by one unrolled pass of max/min exchanges. The
// union of the 8 slices' lists holds the k largest keys; they go to shared
// memory and one warp per query takes them by k rounds of a warp max over
// the keys below the last winner (keys are unique, so that sequence is the
// exact top-k). Staging is what pays: a warp per query, one row per lane
// (the knn_exact.cu structure), reads each row from L1 or L2 once per
// query, and measured six times slower at C=64.
//
// The TPU kernel's wrapped-subtract extraction (one max-reduce per step
// over the resident (qt, n_pad) key tile) is a vector-unit device and is
// not replayed.
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
// 19. The candidate rows are cut into `splits` contiguous slices [s*w,
// (s+1)*w), w = n_pad / splits; each slice keeps its own top-k (blockIdx.z
// is the slice: the flat kernel's scan over the slice's rows, its k
// largest keys written to a (B, M, splits, K) scratch; a slice with fewer
// than k real rows pads with INT_MIN, which never wins while N >= k), then
// knn_split_merge_kernel takes the k largest of the splits*K winners, warp
// per query, and decodes n_pad - 1 - (key & 0x1FFF). Keys are unique, so
// the result is the top-k of the split keys whatever the slicing: the
// slices shape the work, not the answer. Same bound as the flat kernel
// (the scratch is (B, M, splits, K) int32 on top).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "knn_common.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kSlices = 8;  // warps per block, one slice of the rows each
constexpr int kChunk = 8;   // rows of each slice staged per pass

// kSplit: the split kernel's first pass (blockIdx.z = slice, un-shifted
// keys, the slice's k largest KEYS to `out` = the (B, M, splits, K)
// scratch); else the flat kernel (all rows, indices to `out` (B, M, K)).
template <int KMAX, int CV, bool kSplit>
__global__ void __launch_bounds__(kLanes * kSlices)
knn_packed_kernel(const float* __restrict__ x,      // (B, N, CV)
                  const float* __restrict__ q,      // (B, M, CV)
                  const float* __restrict__ cnorm,  // (B, N)
                  const float* __restrict__ qnorm,  // (B, M)
                  int* __restrict__ out,
                  const int* __restrict__ pred,     // () or null
                  int N, int M, int K, int n_pad, int idx_bits) {
  if (pred != nullptr && *pred == 0) return;
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kLanes;
  const int slots = kSlices * KMAX;
  const int stride = slots + 1;  // odd: lane-strided stores avoid conflicts

  float* xs = smem;                           // [kChunk][kSlices][CV]
  float* xn = xs + kChunk * kSlices * CV;     // [kChunk][kSlices]
  int* win = reinterpret_cast<int*>(xn + kChunk * kSlices);  // [32][stride]

  const int qi = min(q0 + lane, M - 1);
  float qv[CV];
  load_query<CV>(qv, q + ((size_t)b * M + qi) * CV);
  const float qn = qnorm[(size_t)b * M + qi];
  const int imask = (1 << idx_bits) - 1;
  const float* xb = x + (size_t)b * N * CV;
  const float* cb = cnorm + (size_t)b * N;
  const int vec = CV / 4;

  int top[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) top[i] = INT_MIN;  // below every real key

  // the rows this block scans: [lo, hi), all of them unless kSplit
  int lo = 0, hi = N;
  if constexpr (kSplit) {
    const int w = n_pad / (int)gridDim.z;
    lo = min((int)blockIdx.z * w, N);
    hi = min(lo + w, N);
  }
  const int per_slice = (hi - lo + kSlices - 1) / kSlices;
  for (int j0 = 0; j0 < per_slice; j0 += kChunk) {
    __syncthreads();
    // stage rows o = lo + (j0 + jj) * kSlices + wi, one of every slice per jj
    for (int t = threadIdx.x; t < kChunk * kSlices * vec; t += blockDim.x) {
      const int c4 = t % vec;
      const int wi = (t / vec) % kSlices;
      const int jj = t / (vec * kSlices);
      const int o = lo + (j0 + jj) * kSlices + wi;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (o < hi) v = reinterpret_cast<const float4*>(xb + (size_t)o * CV)[c4];
      reinterpret_cast<float4*>(xs)[(jj * kSlices + wi) * vec + c4] = v;
      if (c4 == 0) xn[jj * kSlices + wi] = o < hi ? cb[o] : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < kChunk; ++jj) {
      const int o = lo + (j0 + jj) * kSlices + warp;
      if (o >= hi) break;  // warp-uniform
      const float sc = __fsub_rn(
          knn_score<CV, false>(qv, xs + (jj * kSlices + warp) * CV, xn[jj * kSlices + warp]),
          qn);
      int v = ((score_key(sc) >> (kSplit ? 0 : 1)) & ~imask) | (n_pad - 1 - o);
      if (v > top[KMAX - 1]) {
#pragma unroll
        for (int i = 0; i < KMAX; ++i) {
          const int big = max(top[i], v);
          v = min(top[i], v);
          top[i] = big;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < KMAX; ++i) win[lane * stride + warp * KMAX + i] = top[i];
  __syncthreads();

  // merge: warp per query, k rounds of "largest key below the last winner"
  for (int ql = warp; ql < kLanes; ql += kSlices) {
    const int qq = q0 + ql;
    if (qq >= M) break;  // warp-uniform
    const int* keys = win + ql * stride;
    const size_t orow = kSplit ? (((size_t)b * M + qq) * gridDim.z + blockIdx.z) * K
                               : ((size_t)b * M + qq) * K;
    int prev = INT_MAX;
    for (int t = 0; t < K; ++t) {
      int best = INT_MIN;
      for (int i = lane; i < slots; i += kLanes) {
        const int v = keys[i];
        if (v < prev && v > best) best = v;
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        best = max(best, __shfl_xor_sync(0xffffffffu, best, off));
      if (lane == 0) out[orow + t] = kSplit ? best : n_pad - 1 - (best & imask);
      prev = best;
    }
  }
}

// The split kernel's second pass: for each (b, query) row of the
// (B, M, splits, K) winner keys, the K largest, decoded to indices;
// warp per query, K rounds of "largest key below the last winner" (the
// keys are re-read from L1 / L2 each round).
__global__ void __launch_bounds__(kLanes * kSlices)
knn_split_merge_kernel(const int* __restrict__ part,  // (B*M, count)
                       int* __restrict__ out,         // (B*M, K)
                       const int* __restrict__ pred,  // () or null
                       size_t rows, int count, int K, int n_pad, int imask) {
  if (pred != nullptr && *pred == 0) return;
  const int lane = threadIdx.x % kLanes;
  const size_t row = (size_t)blockIdx.x * kSlices + threadIdx.x / kLanes;
  if (row >= rows) return;  // warp-uniform
  const int* keys = part + row * count;
  int prev = INT_MAX;
  for (int t = 0; t < K; ++t) {
    int best = INT_MIN;
    for (int i = lane; i < count; i += kLanes) {
      const int v = keys[i];
      if (v < prev && v > best) best = v;
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      best = max(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (lane == 0) out[row * K + t] = n_pad - 1 - (best & imask);
    prev = best;
  }
}

template <int KMAX, int CV, bool kSplit>
cudaError_t launch(const float* x, const float* q, const float* cnorm,
                   const float* qnorm, int* out, const int* pred, int B, int N,
                   int M, int K, int n_pad, int idx_bits, int splits,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kChunk * kSlices * CV + kChunk * kSlices +
                       (size_t)kLanes * (kSlices * KMAX + 1));
  auto kernel = knn_packed_kernel<KMAX, CV, kSplit>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kLanes - 1) / kLanes, B, splits);
  kernel<<<grid, kLanes * kSlices, smem, stream>>>(
      x, q, cnorm, qnorm, out, pred, N, M, K, n_pad, idx_bits);
  return cudaGetLastError();
}

template <int KMAX, bool kSplit>
cudaError_t launch_cv(int cv, const float* x, const float* q,
                      const float* cnorm, const float* qnorm, int* out,
                      const int* pred, int B, int N, int M, int K, int n_pad,
                      int idx_bits, int splits, cudaStream_t s) {
  switch (cv) {
    case 4: return launch<KMAX, 4, kSplit>(x, q, cnorm, qnorm, out, pred, B, N, M, K, n_pad, idx_bits, splits, s);
    case 8: return launch<KMAX, 8, kSplit>(x, q, cnorm, qnorm, out, pred, B, N, M, K, n_pad, idx_bits, splits, s);
    case 16: return launch<KMAX, 16, kSplit>(x, q, cnorm, qnorm, out, pred, B, N, M, K, n_pad, idx_bits, splits, s);
    case 32: return launch<KMAX, 32, kSplit>(x, q, cnorm, qnorm, out, pred, B, N, M, K, n_pad, idx_bits, splits, s);
    case 64: return launch<KMAX, 64, kSplit>(x, q, cnorm, qnorm, out, pred, B, N, M, K, n_pad, idx_bits, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kSplit>
cudaError_t launch_k(int cv, const float* x, const float* q, const float* cnorm,
                     const float* qnorm, int* out, const int* pred, int B, int N,
                     int M, int K, int n_pad, int idx_bits, int splits,
                     cudaStream_t s) {
  if (K < 1 || K > 2 * kLanes) return cudaErrorInvalidValue;
  if (K <= kLanes)
    return launch_cv<kLanes, kSplit>(cv, x, q, cnorm, qnorm, out, pred, B, N, M, K, n_pad, idx_bits, splits, s);
  return launch_cv<2 * kLanes, kSplit>(cv, x, q, cnorm, qnorm, out, pred, B, N, M, K, n_pad, idx_bits, splits, s);
}

}  // namespace

// x (B,N,cv), q (B,M,cv) with cv in {4,8,16,32,64} (zero-padded channels);
// cnorm (B,N), qnorm (B,M); out (B,M,K) int32 with 1 <= K <= 64 and K <= N;
// n_pad = N rounded up to 128, 13 <= idx_bits <= 15; pred a device int32 or
// null. Returns a cudaError_t.
extern "C" int dgcnn_knn_packed(const float* x, const float* q,
                                const float* cnorm, const float* qnorm,
                                int* out, const int* pred, int B, int N, int M,
                                int cv, int K, int n_pad, int idx_bits,
                                void* stream) {
  return launch_k<false>(cv, x, q, cnorm, qnorm, out, pred, B, N, M, K, n_pad,
                         idx_bits, 1, static_cast<cudaStream_t>(stream));
}

// The split kernel: as dgcnn_knn_packed, with n_pad <= 8192 (13 index
// bits), 2 <= splits <= 65535 dividing n_pad, and `part` a (B,M,splits,K)
// int32 scratch. Two launches on `stream`. Returns a cudaError_t.
extern "C" int dgcnn_knn_packed_split(const float* x, const float* q,
                                      const float* cnorm, const float* qnorm,
                                      int* part, int* out, const int* pred,
                                      int B, int N, int M, int cv, int K,
                                      int n_pad, int splits, void* stream) {
  constexpr int kIdxBits = 13;
  if (n_pad > (1 << kIdxBits) || splits < 2 || splits > 65535 || n_pad % splits)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_k<true>(cv, x, q, cnorm, qnorm, part, pred, B, N, M,
                                   K, n_pad, kIdxBits, splits, s);
  if (err != cudaSuccess) return err;
  const size_t rows = (size_t)B * M;
  if (rows == 0) return cudaSuccess;
  const size_t blocks = (rows + kSlices - 1) / kSlices;
  knn_split_merge_kernel<<<(unsigned)blocks, kLanes * kSlices, 0, s>>>(
      part, out, pred, rows, splits * K, K, n_pad, (1 << kIdxBits) - 1);
  return cudaGetLastError();
}
