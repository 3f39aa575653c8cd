// Row gather of the EdgeConv training forward, for Hopper (sm_90a).
//
// Replaces dgcnn_tpu/kernels/gather_pallas.py::_kernel (launched by
// gather_rows), the kernel behind the JAX package's DGCNN_GATHER_IMPL=pallas;
// the port runs every gather of the training forward on the card here:
//
//   out[b, m, :] = table[b, clamp(idx[b, m], 0, N - 1), :]
//
// Indices are clamped to [0, N): the TPU kernel reads a zero padding row
// for N <= idx < n_pad instead, but the port's plain gather and its
// backward scatters (scatter_rows.cu) clamp, so the scatter stays the
// exact adjoint of this gather. The difference only shows on the padding
// index an overflowing capped kNN can emit.
//
// What bounds it on the H100: bytes. It writes the (B, M, C) output (430
// MB at B=8, M=N*k=210000, C=64; 26.9 MB at C=4) and reads the (B, M)
// indices (6.7 MB) and the table (14.3 MB at C=64) once from device
// memory: 0.135 ms at C=64, 0.010 ms at C=4, at 3.35 TB/s. A batch
// element's table is 1.8 MB at C=64 and all eight fit the 50 MB L2, so
// the random row reads are served by L2; this is the role VMEM played for
// the TPU kernel, which kept the table resident and unrolled dynamic
// sublane loads (its chunk / unroll pair has no counterpart here).
//
// Design. A 2-D grid: blockIdx.y is the batch element, whose base
// pointers are formed once in 64 bits; inside an element every offset is
// a 32-bit int (the launcher refuses M*C or N*C >= 2^31). The element's
// (M, C) output is a run of M*G slots of 16 bytes (G = C/4 groups of 4
// channels); G is a template parameter for the widths the port runs (G=1
// at C=4, G=16 at C=64), so slot -> (row, group) is a shift, not a
// division; other widths take a generic instance with a 32-bit division.
// Each thread takes R slots a block width apart, so every load and store
// instruction of a warp covers consecutive slots, and issues its R index
// loads, then its R table loads, then its R stores: R=4 at C=4 (four
// independent index -> table chains in flight), R=2 at C=64, where 16
// neighbouring lanes share a row (one broadcast index load). Indices and
// table rows are read through the read-only path, so the table stays in
// L1 / L2; the output is written with streaming stores (evict first), so
// it does not push the table out of L2. C % 4 != 0 or a table or output pointer that is not 16-byte
// aligned takes the same kernel on 4-byte slots. No atomics, no shared
// memory: the output is a plain copy of table rows, bit for bit.
// `cuobjdump -sass` (nvcc 12.8, sm_90a): the G=1 and G=16 instances hold
// no division sequence, the generic ones a 32-bit one, none a 64-bit one.
//
// Measured with scripts/torch_row_kernels.py on an H100 80GB HBM3 at 700 W
// (B=8, M=210000, 50 launches queued per pair of events): 0.0125 ms at
// C=4 on kNN-of-blocks indices (82% of the 0.0103 bound; 0.0170 on
// uniform ones) and 0.1596 ms at C=64 (84% of the 0.1347 bound), against
// torch.gather's 0.0303 and 0.317 ms. R and the index load were chosen by
// the same script on variants: at C=4, R=1/2/4 with evict-first index
// loads took 0.0157/0.0148/0.0148 ms, R=2/4 with read-only ones
// 0.0140/0.0127; at C=64 R=2 beat R=4 (0.1598 against 0.1626 ms) and R=8
// lost (0.170).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxY = 65535;  // gridDim.y limit: the batch loop strides past it

// slots per thread: 4 where a slot is a whole row (C=4), else 2
constexpr int kMaxRows = 4;
template <int G>
__host__ __device__ constexpr int rows_per_thread() { return G == 1 ? kMaxRows : 2; }

__device__ __forceinline__ int clamp_row(int t, int n) { return min(max(t, 0), n - 1); }

// T: float4 (16-byte slots) or float (4-byte slots); G: slots per row, 0
// for the run-time width g
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ table,  // (B, N, g) slots
                   const int* __restrict__ idx,  // (B, M)
                   T* __restrict__ out,          // (B, M, g) slots
                   int B, int M, int N, int g_rt) {
  constexpr int R = rows_per_thread<G>();
  const int g = G > 0 ? G : g_rt;
  const int total = M * g;
  const int s0 = blockIdx.x * (kThreads * R) + threadIdx.x;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const T* tb = table + (size_t)b * N * g;
    const int* ib = idx + (size_t)b * M;
    T* ob = out + (size_t)b * M * g;
    int src[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = s0 + r * kThreads;
      src[r] = s < total ? clamp_row(__ldg(ib + s / g), N) * g + s % g : 0;
    }
    T v[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (s0 + r * kThreads < total) v[r] = __ldg(tb + src[r]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = s0 + r * kThreads;
      if (s < total) __stcs(ob + s, v[r]);
    }
  }
}

template <typename T, int G>
int launch(const void* table, const int* idx, void* out, int B, int M, int N, int g,
           cudaStream_t s) {
  constexpr int per_block = kThreads * rows_per_thread<G>();
  const dim3 grid((unsigned)((M * g + per_block - 1) / per_block), (unsigned)min(B, kMaxY));
  gather_rows_kernel<T, G><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(table), idx, static_cast<T*>(out), B, M, N, g);
  return cudaGetLastError();
}

}  // namespace

// table (B,N,C) float32, idx (B,M) int32, out (B,M,C) float32, all
// contiguous; M*C and N*C below 2^31. The 16-byte path needs C % 4 == 0
// and 16-byte aligned table and out. Returns a cudaError_t.
extern "C" int dgcnn_gather_rows(const float* table, const int* idx, float* out,
                                 int B, int M, int N, int C, void* stream) {
  if (B < 0 || M < 0 || N < 1 || C < 1) return cudaErrorInvalidValue;
  if ((long long)M * C > INT_MAX - kThreads * kMaxRows || (long long)N * C > INT_MAX)
    return cudaErrorInvalidValue;
  if (B == 0 || M == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!vec4) return launch<float, 0>(table, idx, out, B, M, N, C, s);
  switch (C / 4) {
    case 1: return launch<float4, 1>(table, idx, out, B, M, N, 1, s);
    case 16: return launch<float4, 16>(table, idx, out, B, M, N, 16, s);
    default: return launch<float4, 0>(table, idx, out, B, M, N, C / 4, s);
  }
}
