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
// Design: one thread per (row, group of 4 channels) when C % 4 == 0, with
// 16-byte loads and stores; neighbouring threads take neighbouring channel
// groups of a row, then the next row, so a warp's stores cover whole
// lines. The output is written with streaming stores (evict first), so it
// does not push the table out of L2. One thread per (row, channel)
// otherwise. No atomics, no shared memory: the output is a plain copy of
// table rows, bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 1u << 20;  // grid-stride beyond this

__device__ __forceinline__ int clamp_row(int t, int n) { return min(max(t, 0), n - 1); }

__global__ void __launch_bounds__(kThreads)
gather_rows_vec4_kernel(const float* __restrict__ table,  // (B, N, C), C % 4 == 0
                        const int* __restrict__ idx,      // (B, M)
                        float* __restrict__ out,          // (B, M, C)
                        int M, int N, int C, size_t total) {
  const int groups = C / 4;
  for (size_t t = blockIdx.x * (size_t)kThreads + threadIdx.x; t < total;
       t += (size_t)gridDim.x * kThreads) {
    const size_t row = t / groups;  // b * M + m
    const int g = (int)(t - row * groups);
    const size_t b = row / M;
    const int src = clamp_row(__ldg(idx + row), N);
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(table + (b * N + src) * C) + g);
    __stcs(reinterpret_cast<float4*>(out + row * C) + g, v);
  }
}

__global__ void __launch_bounds__(kThreads)
gather_rows_scalar_kernel(const float* __restrict__ table,  // (B, N, C)
                          const int* __restrict__ idx,      // (B, M)
                          float* __restrict__ out,          // (B, M, C)
                          int M, int N, int C, size_t total) {
  for (size_t t = blockIdx.x * (size_t)kThreads + threadIdx.x; t < total;
       t += (size_t)gridDim.x * kThreads) {
    const size_t row = t / C;
    const int c = (int)(t - row * C);
    const size_t b = row / M;
    const int src = clamp_row(__ldg(idx + row), N);
    __stcs(out + row * C + c, __ldg(table + (b * N + src) * C + c));
  }
}

}  // namespace

// table (B,N,C) float32, idx (B,M) int32, out (B,M,C) float32, all
// contiguous; the 16-byte path needs C % 4 == 0 and 16-byte aligned table
// and out. Returns a cudaError_t.
extern "C" int dgcnn_gather_rows(const float* table, const int* idx, float* out,
                                 int B, int M, int N, int C, void* stream) {
  if (B < 0 || M < 0 || N < 1 || C < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const size_t total = (size_t)B * M * (vec4 ? C / 4 : C);
  if (total == 0) return cudaSuccess;
  size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vec4)
    gather_rows_vec4_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(table, idx, out, M, N, C, total);
  else
    gather_rows_scalar_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(table, idx, out, M, N, C, total);
  return cudaGetLastError();
}
