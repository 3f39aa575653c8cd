// Training EdgeConv tails for Hopper (sm_90a): BatchNorm on the batch's
// statistics + LeakyReLU(0.2) (+ the max over k), forward and backward, on
// the (B, N, k, 64) FP32 edge activations of a train step.
//
// The JAX package has no Pallas kernel here: its bn_lrelu_train /
// bn_lrelu_max_train custom VJPs (dgcnn_tpu/ops/edgeconv.py) are plain jnp
// chains that XLA fuses into a few loops. In PyTorch each operation of the
// chain is its own pass over the (B, N, k, 64) tensor (~110 a train step);
// these kernels take the chain in one channel-sums pass and one fused pass
// each (ops/edgeconv.py: _BnLrelu, _BnLreluMax, _EdgeStageTail's forward):
//
//   sums       S = (sum e, sum e^2) over the M = B*N*k rows        (forward)
//   apply      z = lrelu((e - mean) * scale + beta)                (no max)
//   max        mx = max_k z, am = first argmax_k z, se = sum_k e   (max tails)
//   grad sums  (sum gp, sum gp * xhat)                             (backward)
//   grad       de = gi * (gp - (t1 + xhat * t2) * (1/m)), d_bvec = sum_k de
//   max grad   de = gi * (dy - (t1 + xhat * t2) * (1/m)), dy = gp at slot am
//
// with e = p + bvec[query] where the caller passes the conv's point term
// (the fold: edge_conv_linear's broadcast add and its sum-over-k backward
// happen here, and e is never written), xhat = (e - mean) * inv,
// y = xhat * gamma + beta and gp = y >= 0 ? g : 0.2 * g.
//
// Bits. The elementwise arithmetic is PyTorch's, operation by operation in
// its order, with round-to-nearest intrinsics (no FMA contraction), so z,
// mx, am, de are bit-equal to the plain versions (kernels/
// edgeconv_train.py) given the same channel vectors; the sums over k (se,
// d_bvec) run j = 0..k-1 in order, and the channel sums in their own order:
// each lane sums its queries' rows in FP32, a block adds its lanes in a
// fixed tree, and a second kernel adds the blocks' partials in FP64. No
// atomics: every sum repeats bit for bit from run to run on one card (the
// sums' grid is the occupancy times the SM count, fixed for a device).
//
// Design. A half-warp takes a query's k contiguous rows of 64 channels, 4
// channels (one float4) a lane, so a row is one 256-byte load of the
// half-warp and the per-query vectors (bvec, mx, am, se, gp) are read or
// written once a query. A lane loads R rows before it uses them (R = 8 with
// one input, 4 with two), which keeps ~64-128 KB of loads in flight an SM.
// What bounds them on the H100: bytes. At B=8, N=7000, k=30 a (B, N, k, 64)
// FP32 tensor is 430 MB, one pass 0.128 ms at 3.35 TB/s: sums 1 pass,
// apply 2, max 1, grad sums 2, grad 3, max grad 2.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kC = 64;              // channels of every tail
constexpr int kLanes = 16;          // a half-warp a query, 4 channels a lane
constexpr int kThreads = 256;       // 16 queries a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 127;          // argmax slots travel as int8
constexpr int kCombineThreads = 1024;
constexpr int kCombineParts = kCombineThreads / (2 * kC);
constexpr float kSlope = 0.2f;      // PyTorch rounds the scalar 0.2 to float

struct F4 {
  float v[4];
};

__device__ __forceinline__ F4 load4(const float* p) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  return {{t.x, t.y, t.z, t.w}};
}

__device__ __forceinline__ void store4(float* p, const F4& a) {
  *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
}

__device__ __forceinline__ F4 zero4() { return {{0.f, 0.f, 0.f, 0.f}}; }

// e = p + bvec (PyTorch's broadcast add), or p without a point term
template <bool kBvec>
__device__ __forceinline__ float point(float p, float b) {
  return kBvec ? __fadd_rn(p, b) : p;
}

// torch.where(y >= 0, y, 0.2 * y)
__device__ __forceinline__ float lrelu(float y) { return y >= 0.f ? y : __fmul_rn(kSlope, y); }

// (e - mean) * scale + beta, then LeakyReLU
__device__ __forceinline__ float bn_lrelu(float e, float mean, float scale, float beta) {
  return lrelu(__fadd_rn(__fmul_rn(__fsub_rn(e, mean), scale), beta));
}

// xhat = (e - mean) * inv
__device__ __forceinline__ float xhat_of(float e, float mean, float inv) {
  return __fmul_rn(__fsub_rn(e, mean), inv);
}

// gp = where(xhat * gamma + beta >= 0, g, 0.2 * g)
__device__ __forceinline__ float gp_of(float xh, float g, float gamma, float beta) {
  return __fadd_rn(__fmul_rn(xh, gamma), beta) >= 0.f ? g : __fmul_rn(kSlope, g);
}

// gi * (dy - (t1 + xhat * t2) * inv_m)
__device__ __forceinline__ float de_of(float dy, float xh, float gi, float t1, float t2,
                                       float inv_m) {
  return __fmul_rn(gi, __fsub_rn(dy, __fmul_rn(__fadd_rn(t1, __fmul_rn(xh, t2)), inv_m)));
}

__device__ __forceinline__ int half_warp() {
  return (int)(((long long)blockIdx.x * kThreads + threadIdx.x) / kLanes);
}
__device__ __forceinline__ int half_warps() { return gridDim.x * (kThreads / kLanes); }
__device__ __forceinline__ int chan0() { return 4 * (threadIdx.x % kLanes); }

enum SumMode { kStats = 0, kGradStats = 1 };

// Per-block channel sums into partial[block][2][64]: kStats (sum e, sum
// e^2); kGradStats (sum gp, sum gp * xhat), reading g too. Each lane keeps
// FP32 sums over its queries (a grid-stride loop over the queries), the two
// half-warps of a warp add by a shuffle, then the warps in order.
template <int kMode, bool kBvec>
__global__ void __launch_bounds__(kThreads)
train_tail_sums_kernel(const float* __restrict__ e, const float* __restrict__ bvec,
                       const float* __restrict__ g, const float* __restrict__ mean,
                       const float* __restrict__ inv, const float* __restrict__ gamma,
                       const float* __restrict__ beta, float* __restrict__ partial,
                       int Q, int k) {
  constexpr int R = kMode == kStats ? 8 : 4;
  const int c0 = chan0();
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  F4 mu = zero4(), iv = zero4(), ga = zero4(), be = zero4();
  if (kMode == kGradStats) {
    mu = load4(mean + c0);
    iv = load4(inv + c0);
    ga = load4(gamma + c0);
    be = load4(beta + c0);
  }
  for (int q = half_warp(); q < Q; q += half_warps()) {
    const size_t base = (size_t)q * k * kC + c0;
    const F4 bq = kBvec ? load4(bvec + (size_t)q * kC + c0) : zero4();
    for (int j0 = 0; j0 < k; j0 += R) {
      F4 ev[R], gv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (j0 + r < k) {
          ev[r] = load4(e + base + (size_t)(j0 + r) * kC);
          if (kMode == kGradStats) gv[r] = load4(g + base + (size_t)(j0 + r) * kC);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (j0 + r < k) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = point<kBvec>(ev[r].v[i], bq.v[i]);
            if (kMode == kStats) {
              s1[i] += x;
              s2[i] = fmaf(x, x, s2[i]);
            } else {
              const float xh = xhat_of(x, mu.v[i], iv.v[i]);
              const float gp = gp_of(xh, gv[r].v[i], ga.v[i], be.v[i]);
              s1[i] += gp;
              s2[i] = fmaf(gp, xh, s2[i]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], kLanes);
    s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], kLanes);
  }
  __shared__ float red[kWarps][2 * kC];
  if (threadIdx.x % 32 < kLanes) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      red[threadIdx.x / 32][c0 + i] = s1[i];
      red[threadIdx.x / 32][kC + c0 + i] = s2[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kC) {
    float t = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += red[w][threadIdx.x];
    partial[(size_t)blockIdx.x * 2 * kC + threadIdx.x] = t;
  }
}

// out[s][c] = sum over blocks of partial[block][s][c], in FP64: eight
// parts of 128 threads each take every eighth block, then one part adds
// the eight in order; rounded to FP32 once.
__global__ void __launch_bounds__(kCombineThreads)
train_tail_combine_kernel(const float* __restrict__ partial, int blocks,
                          float* __restrict__ out) {
  __shared__ double part[kCombineParts][2 * kC];
  const int j = threadIdx.x % (2 * kC), p = threadIdx.x / (2 * kC);
  double t = 0.0;
  for (int b = p; b < blocks; b += kCombineParts) t += (double)partial[(size_t)b * 2 * kC + j];
  part[p][j] = t;
  __syncthreads();
  if (threadIdx.x < 2 * kC) {
    double s = part[0][j];
#pragma unroll
    for (int q = 1; q < kCombineParts; ++q) s += part[q][j];
    out[j] = (float)s;
  }
}

// z = lrelu((e - mean) * scale + beta) on every row
template <bool kBvec>
__global__ void __launch_bounds__(kThreads)
train_tail_apply_kernel(const float* __restrict__ e, const float* __restrict__ bvec,
                        const float* __restrict__ mean, const float* __restrict__ scale,
                        const float* __restrict__ beta, float* __restrict__ z, int Q, int k) {
  constexpr int R = 8;
  const int c0 = chan0();
  const F4 mu = load4(mean + c0), sc = load4(scale + c0), be = load4(beta + c0);
  for (int q = half_warp(); q < Q; q += half_warps()) {
    const size_t base = (size_t)q * k * kC + c0;
    const F4 bq = kBvec ? load4(bvec + (size_t)q * kC + c0) : zero4();
    for (int j0 = 0; j0 < k; j0 += R) {
      F4 ev[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (j0 + r < k) ev[r] = load4(e + base + (size_t)(j0 + r) * kC);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (j0 + r < k) {
          F4 out;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            out.v[i] = bn_lrelu(point<kBvec>(ev[r].v[i], bq.v[i]), mu.v[i], sc.v[i], be.v[i]);
          store4(z + base + (size_t)(j0 + r) * kC, out);
        }
      }
    }
  }
}

// mx = max_k z, am = the first k-slot holding it (a NaN wins, the first
// one: torch's amax / argmax), se = sum_k e in slot order (kSum)
template <bool kBvec, bool kSum>
__global__ void __launch_bounds__(kThreads)
train_tail_max_kernel(const float* __restrict__ e, const float* __restrict__ bvec,
                      const float* __restrict__ mean, const float* __restrict__ scale,
                      const float* __restrict__ beta, float* __restrict__ mx,
                      int8_t* __restrict__ am, float* __restrict__ se, int Q, int k) {
  constexpr int R = 8;
  const int c0 = chan0();
  const F4 mu = load4(mean + c0), sc = load4(scale + c0), be = load4(beta + c0);
  for (int q = half_warp(); q < Q; q += half_warps()) {
    const size_t base = (size_t)q * k * kC + c0;
    const F4 bq = kBvec ? load4(bvec + (size_t)q * kC + c0) : zero4();
    F4 best = zero4(), acc = zero4();
    int arg[4] = {0, 0, 0, 0};
    for (int j0 = 0; j0 < k; j0 += R) {
      F4 ev[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (j0 + r < k) ev[r] = load4(e + base + (size_t)(j0 + r) * kC);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = j0 + r;
        if (j < k) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = point<kBvec>(ev[r].v[i], bq.v[i]);
            const float zz = bn_lrelu(x, mu.v[i], sc.v[i], be.v[i]);
            if (j == 0 || zz > best.v[i] || (isnan(zz) && !isnan(best.v[i]))) {
              best.v[i] = zz;
              arg[i] = j;
            }
            if (kSum) acc.v[i] = j == 0 ? x : __fadd_rn(acc.v[i], x);
          }
        }
      }
    }
    const size_t out = (size_t)q * kC + c0;
    store4(mx + out, best);
    *reinterpret_cast<char4*>(am + out) =
        make_char4((signed char)arg[0], (signed char)arg[1], (signed char)arg[2],
                   (signed char)arg[3]);
    if (kSum) store4(se + out, acc);
  }
}

// _BnLrelu's cotangent: de on every row, d_bvec = sum_k de in slot order
// (kBvec)
template <bool kBvec>
__global__ void __launch_bounds__(kThreads)
train_tail_grad_kernel(const float* __restrict__ e, const float* __restrict__ bvec,
                       const float* __restrict__ g, const float* __restrict__ mean,
                       const float* __restrict__ inv, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ gi,
                       const float* __restrict__ t1, const float* __restrict__ t2,
                       float inv_m, float* __restrict__ de, float* __restrict__ d_bvec,
                       int Q, int k) {
  constexpr int R = 4;
  const int c0 = chan0();
  const F4 mu = load4(mean + c0), iv = load4(inv + c0), ga = load4(gamma + c0),
           be = load4(beta + c0), gs = load4(gi + c0), u1 = load4(t1 + c0),
           u2 = load4(t2 + c0);
  for (int q = half_warp(); q < Q; q += half_warps()) {
    const size_t base = (size_t)q * k * kC + c0;
    const F4 bq = kBvec ? load4(bvec + (size_t)q * kC + c0) : zero4();
    F4 acc = zero4();
    for (int j0 = 0; j0 < k; j0 += R) {
      F4 ev[R], gv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (j0 + r < k) {
          ev[r] = load4(e + base + (size_t)(j0 + r) * kC);
          gv[r] = load4(g + base + (size_t)(j0 + r) * kC);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = j0 + r;
        if (j < k) {
          F4 out;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float xh = xhat_of(point<kBvec>(ev[r].v[i], bq.v[i]), mu.v[i], iv.v[i]);
            const float gp = gp_of(xh, gv[r].v[i], ga.v[i], be.v[i]);
            out.v[i] = de_of(gp, xh, gs.v[i], u1.v[i], u2.v[i], inv_m);
            if (kBvec) acc.v[i] = j == 0 ? out.v[i] : __fadd_rn(acc.v[i], out.v[i]);
          }
          store4(de + base + (size_t)j * kC, out);
        }
      }
    }
    if (kBvec) store4(d_bvec + (size_t)q * kC + c0, acc);
  }
}

// _BnLreluMax's cotangent: de on every row, the (B, N, 64) max cotangent gp
// routed to slot am (no (B, N, k, 64) routed tensor)
__global__ void __launch_bounds__(kThreads)
train_tail_max_grad_kernel(const float* __restrict__ e, const int8_t* __restrict__ am,
                           const float* __restrict__ gp, const float* __restrict__ mean,
                           const float* __restrict__ inv, const float* __restrict__ gi,
                           const float* __restrict__ t1, const float* __restrict__ t2,
                           float inv_m, float* __restrict__ de, int Q, int k) {
  constexpr int R = 8;
  const int c0 = chan0();
  const F4 mu = load4(mean + c0), iv = load4(inv + c0), gs = load4(gi + c0),
           u1 = load4(t1 + c0), u2 = load4(t2 + c0);
  for (int q = half_warp(); q < Q; q += half_warps()) {
    const size_t base = (size_t)q * k * kC + c0;
    const F4 gq = load4(gp + (size_t)q * kC + c0);
    const char4 a = __ldg(reinterpret_cast<const char4*>(am + (size_t)q * kC + c0));
    const int slot[4] = {a.x, a.y, a.z, a.w};
    for (int j0 = 0; j0 < k; j0 += R) {
      F4 ev[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (j0 + r < k) ev[r] = load4(e + base + (size_t)(j0 + r) * kC);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = j0 + r;
        if (j < k) {
          F4 out;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float xh = xhat_of(ev[r].v[i], mu.v[i], iv.v[i]);
            out.v[i] = de_of(slot[i] == j ? gq.v[i] : 0.f, xh, gs.v[i], u1.v[i], u2.v[i],
                             inv_m);
          }
          store4(de + base + (size_t)j * kC, out);
        }
      }
    }
  }
}

bool bad_shape(long long Q, int k) { return Q < 0 || Q > INT_MAX / kLanes || k < 1 || k > kMaxK; }

unsigned rows_grid(long long Q) { return (unsigned)((Q + kThreads / kLanes - 1) / (kThreads / kLanes)); }

// the channel sums' grid: as many blocks as the card holds at once (a
// fixed number for a device, so the sums' order is too), fewer for few
// queries
template <int kMode, bool kBvec>
cudaError_t sums_grid(long long Q, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, train_tail_sums_kernel<kMode, kBvec>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long most = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const long long need = rows_grid(Q);
  *blocks = (int)(need < most ? need : most);
  return cudaSuccess;
}

template <int kMode, bool kBvec>
int launch_sums(const float* e, const float* bvec, const float* g, const float* mean,
                const float* inv, const float* gamma, const float* beta, float* partial,
                int capacity, float* out, int Q, int k, cudaStream_t s) {
  int blocks = 0;
  cudaError_t err = sums_grid<kMode, kBvec>(Q, &blocks);
  if (err != cudaSuccess) return err;
  if (blocks > capacity) return cudaErrorInvalidValue;
  train_tail_sums_kernel<kMode, kBvec><<<blocks, kThreads, 0, s>>>(
      e, bvec, g, mean, inv, gamma, beta, partial, Q, k);
  train_tail_combine_kernel<<<1, kCombineThreads, 0, s>>>(partial, blocks, out);
  return cudaGetLastError();
}

}  // namespace

// The forward channel sums: out (2, 64) = (sum e, sum e^2) over the Q*k
// rows of e (Q, k, 64), e = p + bvec[q] where bvec (Q, 64) is given (NULL:
// e = p). partial: scratch of `capacity` blocks x 128 floats (8 blocks an
// SM always fit). All float32, contiguous. Returns a cudaError_t.
extern "C" int dgcnn_train_tail_sums(const float* p, const float* bvec, float* partial,
                                     int capacity, float* out, int Q, int k, void* stream) {
  if (bad_shape(Q, k) || capacity < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q == 0) return cudaMemsetAsync(out, 0, 2 * kC * sizeof(float), s);
  return bvec ? launch_sums<kStats, true>(p, bvec, nullptr, nullptr, nullptr, nullptr, nullptr,
                                          partial, capacity, out, Q, k, s)
              : launch_sums<kStats, false>(p, nullptr, nullptr, nullptr, nullptr, nullptr,
                                           nullptr, partial, capacity, out, Q, k, s);
}

// The backward channel sums of _BnLrelu: out (2, 64) = (sum gp, sum gp *
// xhat) over the rows of e = p (+ bvec) and its cotangent g (Q, k, 64);
// mean, inv, gamma, beta (64). As dgcnn_train_tail_sums otherwise.
extern "C" int dgcnn_train_tail_grad_sums(const float* p, const float* bvec, const float* g,
                                          const float* mean, const float* inv,
                                          const float* gamma, const float* beta,
                                          float* partial, int capacity, float* out, int Q,
                                          int k, void* stream) {
  if (bad_shape(Q, k) || capacity < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q == 0) return cudaMemsetAsync(out, 0, 2 * kC * sizeof(float), s);
  return bvec ? launch_sums<kGradStats, true>(p, bvec, g, mean, inv, gamma, beta, partial,
                                              capacity, out, Q, k, s)
              : launch_sums<kGradStats, false>(p, nullptr, g, mean, inv, gamma, beta, partial,
                                               capacity, out, Q, k, s);
}

// z (Q, k, 64) = lrelu((e - mean) * scale + beta), e = p (+ bvec).
extern "C" int dgcnn_train_tail_apply(const float* p, const float* bvec, const float* mean,
                                      const float* scale, const float* beta, float* z, int Q,
                                      int k, void* stream) {
  if (bad_shape(Q, k)) return cudaErrorInvalidValue;
  if (Q == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bvec)
    train_tail_apply_kernel<true><<<rows_grid(Q), kThreads, 0, s>>>(p, bvec, mean, scale, beta,
                                                                    z, Q, k);
  else
    train_tail_apply_kernel<false><<<rows_grid(Q), kThreads, 0, s>>>(p, nullptr, mean, scale,
                                                                     beta, z, Q, k);
  return cudaGetLastError();
}

// mx (Q, 64) = max_k lrelu((e - mean) * scale + beta), am (Q, 64) int8 the
// first slot of it, and se (Q, 64) = sum_k e where se is given (NULL: not
// written); e = p (+ bvec).
extern "C" int dgcnn_train_tail_max(const float* p, const float* bvec, const float* mean,
                                    const float* scale, const float* beta, float* mx,
                                    int8_t* am, float* se, int Q, int k, void* stream) {
  if (bad_shape(Q, k)) return cudaErrorInvalidValue;
  if (Q == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = rows_grid(Q);
  if (bvec && se)
    train_tail_max_kernel<true, true><<<grid, kThreads, 0, s>>>(p, bvec, mean, scale, beta, mx,
                                                                am, se, Q, k);
  else if (bvec)
    train_tail_max_kernel<true, false><<<grid, kThreads, 0, s>>>(p, bvec, mean, scale, beta,
                                                                 mx, am, nullptr, Q, k);
  else if (se)
    train_tail_max_kernel<false, true><<<grid, kThreads, 0, s>>>(p, nullptr, mean, scale, beta,
                                                                 mx, am, se, Q, k);
  else
    train_tail_max_kernel<false, false><<<grid, kThreads, 0, s>>>(p, nullptr, mean, scale,
                                                                  beta, mx, am, nullptr, Q, k);
  return cudaGetLastError();
}

// de (Q, k, 64) = gi * (gp - (t1 + xhat * t2) * (1/m)) with e = p (+ bvec)
// and its cotangent g, and d_bvec (Q, 64) = sum_k de where bvec is given;
// 1/m rounded to float as PyTorch rounds the scalar.
extern "C" int dgcnn_train_tail_grad(const float* p, const float* bvec, const float* g,
                                     const float* mean, const float* inv, const float* gamma,
                                     const float* beta, const float* gi, const float* t1,
                                     const float* t2, int m, float* de, float* d_bvec, int Q,
                                     int k, void* stream) {
  if (bad_shape(Q, k) || m < 1 || (bvec && !d_bvec)) return cudaErrorInvalidValue;
  if (Q == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float inv_m = (float)(1.0 / (double)m);
  if (bvec)
    train_tail_grad_kernel<true><<<rows_grid(Q), kThreads, 0, s>>>(
        p, bvec, g, mean, inv, gamma, beta, gi, t1, t2, inv_m, de, d_bvec, Q, k);
  else
    train_tail_grad_kernel<false><<<rows_grid(Q), kThreads, 0, s>>>(
        p, nullptr, g, mean, inv, gamma, beta, gi, t1, t2, inv_m, de, nullptr, Q, k);
  return cudaGetLastError();
}

// de (Q, k, 64) = gi * (dy - (t1 + xhat * t2) * (1/m)), dy = gp (Q, 64) at
// slot am (Q, 64, int8) and 0 elsewhere.
extern "C" int dgcnn_train_tail_max_grad(const float* e, const int8_t* am, const float* gp,
                                         const float* mean, const float* inv, const float* gi,
                                         const float* t1, const float* t2, int m, float* de,
                                         int Q, int k, void* stream) {
  if (bad_shape(Q, k) || m < 1) return cudaErrorInvalidValue;
  if (Q == 0) return cudaSuccess;
  const float inv_m = (float)(1.0 / (double)m);
  train_tail_max_grad_kernel<<<rows_grid(Q), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      e, am, gp, mean, inv, gi, t1, t2, inv_m, de, Q, k);
  return cudaGetLastError();
}
