// What the kNN kernels share: the FP32 score of the exact kernels
// (knn_exact.cu, knn_exact_banded.cu) and the packed one (knn_packed.cu),
// its order-exact int32 key, the band start of a query tile (the banded
// kernels, knn_banded.cu and knn_exact_banded.cu), and the asynchronous
// copies into shared memory that knn_banded.cu and knn_capped.cu stage
// their tiles with.
//
//   score(q, o) = 2 * <q, x_o> - |x_o|^2
//
// The dot is one sequential fmaf chain over channels 0..CV-1 from 0, then
// one explicitly rounded multiply by 2 (exact) and one rounded subtraction
// of the row's norm (the wrapper's `(x * x).sum(-1)` tensor). Every kernel
// that includes this header computes the same bits for the same (q, row,
// norm), so the banded exact kNN selects exactly what the flat exact kNN
// selects, on every input, not only where the dot is exact.

#pragma once

#include <cuda_runtime.h>

// The query row of `CV` channels, from global memory, into registers.
template <int CV>
__device__ __forceinline__ void load_query(float (&qv)[CV], const float* q) {
  const float4* qrow = reinterpret_cast<const float4*>(q);
#pragma unroll
  for (int c4 = 0; c4 < CV / 4; ++c4) {
    const float4 t = qrow[c4];
    qv[4 * c4] = t.x;
    qv[4 * c4 + 1] = t.y;
    qv[4 * c4 + 2] = t.z;
    qv[4 * c4 + 3] = t.w;
  }
}

// score(q, row) with `row` in global memory (kGlobal: read-only cache) or
// in shared memory; `cn` is the row's squared norm.
template <int CV, bool kGlobal>
__device__ __forceinline__ float knn_score(const float (&qv)[CV],
                                           const float* row, float cn) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float dot = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < CV / 4; ++c4) {
    const float4 v = kGlobal ? __ldg(r4 + c4) : r4[c4];
    dot = fmaf(qv[4 * c4], v.x, dot);
    dot = fmaf(qv[4 * c4 + 1], v.y, dot);
    dot = fmaf(qv[4 * c4 + 2], v.z, dot);
    dot = fmaf(qv[4 * c4 + 3], v.w, dot);
  }
  return __fsub_rn(__fmul_rn(2.f, dot), cn);  // explicit roundings
}

// The order-exact monotone int32 of an FP32 score: where(bits >= 0, bits,
// INT_MIN - bits); for negative bits INT_MIN - bits == -(bits & 0x7fffffff),
// which cannot overflow. -0.0 and +0.0 both map to 0.
__device__ __forceinline__ int score_key(float s) {
  const int bits = __float_as_int(s);
  return bits >= 0 ? bits : -(bits & 0x7fffffff);
}

// _band_starts for one query tile: the tile's centre minus half a band,
// floored to a multiple of 128 and clipped to [0, n_pad - band]
__device__ __forceinline__ int band_start(int tile, int qt, int n_pad,
                                          int band) {
  const int raw = tile * qt + qt / 2 - band / 2;
  if (raw < 0) return 0;  // floor-to-128 of a negative row is negative
  return min((raw / 128) * 128, n_pad - band);
}

// cp.async: `bytes` (16, or 4) from global to shared memory without a
// register round trip; when `ok` is false nothing is read and the
// destination is zero-filled (`gmem` must still be a valid address). A
// thread commits its copies as a group and waits for all but the newest
// `N` groups; a barrier then makes every thread's copies visible.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
