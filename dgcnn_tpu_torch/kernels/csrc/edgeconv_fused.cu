// Fused eval EdgeConv stages with the neighbour gather inside the kernel,
// for Hopper (sm_90a).
//
// Replaces dgcnn_tpu/kernels/edgeconv_pallas.py::_stage_kernel (launched by
// edgeconv_fused_stage) and ::_extrema_kernel (edgeconv_fused_extrema):
//
//   stage   out[q] = max_j lrelu(BN_b(W2^T lrelu(BN_a(table[idx[q,j]] + bvec[q]))))
//   extrema out[q] = lrelu(scale * sel + shift),
//            sel   = (gamma >= 0 ? max_j : min_j)(table[idx[q,j]]) + bvec[q]
//
// with BN folded to per-channel (scale, shift) and LeakyReLU slope 0.2.
// The (B, N, k, 64) gathered tensor never exists in device memory: that
// is the point of both TPU kernels, and of these. Neighbour indices are
// clamped to [0, N), the semantics of the unfused chain's XLA gather.
//
// What bounds them on the H100. Stage: the 64x64 second conv on every
// gathered row, B*N*k*64*64 FP32 FMAs (6.9 G at B=8, N=7000, k=30: 0.205
// ms at 67 TFLOP/s); the gather reads B*N*k*64*4 bytes (430 MB) whose
// source table (1.8 MB per cloud) sits in L2. Extrema: only the gather,
// so L2 bandwidth and load latency.
//
// The stage kernel's arithmetic, which every design must keep bit for bit:
//   e[j,d] = lrelu(affine(table[clamp(idx[q,j]), d] + bvec[q,d], sa[d], ta[d]))
//   h[j,c] = one fmaf chain over d = 0..63 ascending, from 0.f, of e[j,d] * W2[d,c]
//   out[c] = max_j lrelu(affine(h[j,c], sb[c], tb[c]))
// with affine(v, s, t) = (v * s) + t rounded twice and the add rounded.
//
// Stage design. A warp owns one query at a time and works in units of 32
// gathered rows (k rows padded to a multiple of 32 by repeating the last
// neighbour, which leaves the max unchanged; k > 32 takes several units,
// the max carried over). The grid is persistent (as many blocks as fit on
// the SMs), and warp w of the grid walks queries w, w + G, w + 2G, ... (G
// the grid's warps), independently of the block's other warps once W2 is
// in shared memory. Per unit:
//
// * gather: the unit's 32 rows and the query's bvec arrive by cp.async
//   (16 bytes a lane, 256 bytes a row) in a staging buffer of the warp's
//   own; the warp has `nbuf` of them and stages unit u + nbuf - 1 while it
//   multiplies unit u (the neighbour indices are loaded one unit earlier
//   still, so no load waits in the loop);
// * transform: one pass over the staged tile applies bvec, BN_a and the
//   LeakyReLU in place, once per element;
// * product: lane (rg, cg) = (lane / 8, lane % 8) holds an 8 x 8 register
//   tile, rows rg + 4i and channels 4cg..4cg+3, 32+4cg..32+4cg+3: per four
//   input channels it reads 8 float4 of the tile (the warp's four rows of a
//   read sit in four bank groups: rows are 68 floats apart) and 8 float4 of
//   W2 (the warp's 8 channel groups read 128 contiguous bytes) for 256
//   FMAs, 1 byte of shared memory per FMA (8 rows x 2 channels a lane
//   would take 2.5);
// * epilogue: the max over the tile's rows in registers, then over the 4
//   row groups by two shuffles; the query's 64 outputs are written once.
//
// The epilogue takes the max before BN_b and the LeakyReLU. For a channel
// whose folded scale is finite and non-zero and whose shift is finite,
// v -> lrelu(affine(v, s, t)) is monotone (rounding is), non-decreasing
// for s > 0, so max_j f(h_j) = f(max_j h_j); NaN rows are skipped by fmaxf
// either way, and with no row left both give -inf. For s < 0 the block
// loads W2's column negated (exact: the fmaf chain of -W2 is -h, rounding
// being symmetric) and uses -s. A lane with any other channel (a zero or
// non-finite scale, a non-finite shift) applies f to every row before the
// max, as the replaced kernel did. The outputs equal the replaced kernel's
// as floats (torch.equal; a zero's sign may differ) on every input.
//
// The wrapper (kernels/edgeconv_fused.py::launch_geometry) picks the warps
// per block and the buffers; shared memory (W2 plus warps x nbuf staging
// tiles) does not depend on k. The launcher refuses (cudaErrorInvalidValue)
// a geometry outside 1..12 warps and 1..2 buffers. Shipped: 12 warps (3 on
// each of the SM's 4 schedulers) with 2 buffers, 231,808 bytes, one block
// per SM. On the H100 (scripts/exp_edgeconv_stage_variants.py) the
// product alone, without gather or transform, takes about 90% of the
// kernel's time; 8 warps are 10% slower, 10 (unequal schedulers) 17%;
// 16 warps spill at 128 registers; reading the tile one step ahead, two
// channels a read, or unrolling the 4-channel steps 1, 4 or 16 times was
// no faster.
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.9; the build log beside the
// library): 168 registers (the 384-thread bound), no spill;
// `cuobjdump -sass`: 512 FFMA in the product loop, no HMMA or GMMA.
//
// bf16 stage kernel (edgeconv_stage_bf16_kernel). Replaces the same
// _stage_kernel with its static flag bf16_mm set, which the JAX model
// takes for compute_dtype="bfloat16": the second conv's operands, the
// activated rows and W2, are rounded to bf16 (round to nearest even) and
// multiplied with an FP32 result that is never rounded to bf16:
//   e[j,d]  = lrelu(fmaf(table[clamp(idx[q,j]), d] + bvec[q,d], sa[d], ta[d]))
//   h[j,c]  = sum_d bf16(e[j,d]) * bf16(W2[d,c])  (exact products, FP32 sums)
//   out[c]  = max_j lrelu(affine(h[j,c], sb[c], tb[c]))
// BN_a is one fused multiply-add here (rounded once), as the plain version
// and the JAX package's stage on the CPU compute it: the bf16 rounding of
// e would turn the ulp between the two roundings into a bf16 ulp now and
// then. Only the order of the 64-term sums differs from the plain version
// (the tensor cores add a k-step's products at once), so the two agree
// within a few FP32 ulps of the sums, not bit for bit.
//
// What bounds it on the H100. The product: 2*B*N*k*64*64 operations (13.8
// G at B=8, N=7000, k=30) at 989 TFLOP/s of dense bf16, 0.014 ms. The bytes:
// table, bvec, idx and the output, ~50 MB at 3.35 TB/s, 0.015 ms. The
// gather: B*N*k rows of 256 bytes (430 MB) from a 1.8 MB table that L2
// holds, ~0.075 ms at the L2 read rate chip_smoke.py measures (5.7 TB/s):
// the practical ceiling, far above the product's bound.
//
// The first design was the FP32 kernel's frame (warps walking queries a
// grid apart, cp.async staging past L1, a transform pass in shared memory,
// ldmatrix fragments) with the product on the tensor cores: 0.120-0.130 ms,
// 1.6x the gather's L2 ceiling. It was built for a product that takes 90%
// of the FP32 kernel's time; on the tensor cores the gather sets the pace,
// and that frame read every row from L2 (no two warps of an SM on
// neighbouring queries, copies that skip L1, 224 KB of shared memory
// leaving L1 none). This design is built around the gather:
// * the product is D[c][r] = sum_d W2[d][c] e[r][d] by mma.sync m16n8k16
//   (bf16, FP32 accumulation): W2^T the A operand (4 m-tiles of output
//   channels), the rows the B operand (n-tiles of 8 rows), k-steps 0..3
//   ascending from a zero accumulator, the first design's chain per output
//   (the same products at the same k positions): the outputs are its
//   outputs bit for bit. Each lane holds W2^T's fragments (64 registers,
//   rounded to bf16, negated where flipped) for the whole kernel, so the
//   kernel takes no shared memory;
// * lane (g, t) = (lane / 4, lane % 4) needs, of row g of an n-tile,
//   channels 16s + 2t, +1 and 16s + 2t + 8, +9 (s = 0..3): eight 8-byte
//   loads, a warp's load covering eight rows' 32-byte sectors whole. The
//   lane applies bvec, BN_a (fmaf) and the LeakyReLU in FP32 to what it
//   loaded and packs its B fragment with __floats2bfloat162_rn: no
//   staging, no transform pass, no ldmatrix;
// * rows come by the read-only path through L1, which has all of the SM's
//   on-chip memory (carveout 0); each block takes a contiguous range of
//   queries, its warps neighbouring queries (q, q + warps, ...), so that
//   rows neighbouring queries share are read from L2 once per SM, as in the
//   extrema kernel; the indices and bvec, read once, are streamed past L1;
// * loads run a unit ahead: the next unit's rows of n-tile j go into the
//   registers n-tile j of this unit was just read from, its bvec into
//   those of this unit's bvec after their last use; the indices are loaded
//   two units ahead. The loop body is one straight line (loads past a
//   warp's last unit read rows that exist; a query's cloud is found by a
//   multiply, not a division; the epilogue's reduction runs at every unit,
//   only its stores predicated), so that the compiler overlaps one n-tile's
//   products with the next one's loads and activation: on the H100,
//   versions with branches between the n-tiles (skipping n-tiles of padding
//   alone, the per-row epilogue below) or a division in the loop were
//   markedly slower. Units are 32 rows, as in the first design;
// * epilogue: lane (g, t) keeps the running max of rows 2t, 2t + 1 of each
//   n-tile for channels 16m + g and 16m + g + 8 (m = 0..3), with the FP32
//   kernel's max-before-BN_b rule when all 64 channels are regular (a
//   warp-uniform choice between two instances of the loop; the other
//   applies BN_b and the LeakyReLU to every row before the max, the same
//   values for the regular channels); two shuffles reduce over t, and at a
//   query's last unit lane (g, t) writes channels 16t + g and 16t + g + 8.
// The launcher takes 1..8 warps a block (8 shipped: 255 registers a thread
// hold one block an SM) and `per` queries a block, each block a contiguous
// range (kernels/edgeconv_fused.py::launch_geometry_bf16: one block an SM).
// Resources (nvcc -Xptxas -v, sm_90a): 254 registers, no spill, no shared
// memory; `cuobjdump -sass`: 64 HMMA in each of the loop's two instances,
// no LDSM, no GMMA.
//
// What holds it (patched builds, scripts/exp_edgeconv_stage_variants.py
// --bf16; times in PERF.md, row 12): mma.sync's rate on Hopper, far below
// the dense bf16 peak (the products alone take about 0.04 ms, and half of
// them take as much off the kernel), and the activation's FP32 work (about
// 0.05 ms alone), which overlap poorly at two warps a scheduler. Designs on
// wgmma (the rows activated into shared memory, the product asynchronous,
// W2 split over a warpgroup) made the product cheap but paid a barrier and
// a tile's round trip per unit, and were no faster.
//
// TF32 stage kernel (edgeconv_stage_tf32_kernel). Replaces the same
// _stage_kernel traced under jax.default_matmul_precision("default"), the
// JAX model's matmul_precision="default": its dot then multiplies FP32
// operands in the backend's reduced precision, which on this card is TF32.
// The second conv's operands are rounded to TF32 by the port's bit rule
// (ops/matmul.py::round_tf32: the 13 low mantissa bits dropped, to nearest
// even; inf as it is; a NaN stays a NaN) and multiplied with FP32 sums:
//   e[j,d]  = lrelu(affine(table[clamp(idx[q,j]), d] + bvec[q,d], sa[d], ta[d]))
//   h[j,c]  = sum_d tf32(e[j,d]) * tf32(W2[d,c])  (exact products, FP32 sums)
//   out[c]  = max_j lrelu(affine(h[j,c], sb[c], tb[c]))
// BN_a is the FP32 kernel's two roundings, as the plain version computes
// it. Only the order of the 64-term sums differs from the plain version,
// so the two agree within the sum-order bound, not bit for bit (bit for bit
// where every sum is exact, e.g. on integers).
//
// What bounds it on the H100: the product, 2*B*N*k*64*64 operations (13.8 G
// at B=8, N=7000, k=30) at 495 TFLOP/s of dense TF32, 0.028 ms; the bytes,
// ~50 MB at 3.35 TB/s, 0.015 ms; the gather's L2 ceiling as for the bf16
// kernel, ~0.075 ms.
//
// Design: the bf16 kernel's walk (a contiguous range of queries a block,
// rows loaded straight into fragments through L1, the same epilogue and
// max-before-BN_b rule), with mma.sync m16n8k8 (tf32, FP32 accumulation),
// D[c][r] = sum_d W2[d][c] e[r][d], k-steps of 8 input channels. W2^T as
// TF32 takes 128 registers a lane, which with the rows in flight is more
// than a thread has, so the block holds it in shared memory (16 KB), in
// fragment order: one 16-byte read a lane per (m-tile, k-step),
// consecutive lanes on consecutive addresses. The k positions are a
// permutation of the input channels, the same for both operands (a sum's
// terms may be taken in any order): lane (g, t) loads channels
// 16i + 4t .. 16i + 4t + 3 (i = 0..3) of row g of an n-tile, four 16-byte
// loads, and k-step s = 2i + v takes channels 16i + 4t + 2v (k row t) and
// 16i + 4t + 2v + 1 (k row t + 4). W2's NaNs are made the canonical NaN
// before the rounding, so that the tensor cores, which read a value's top
// 19 bits, see a NaN; the activations, results of arithmetic, are canonical
// already. A unit runs n-tile by n-tile: the n-tile's rows activated and
// rounded, then multiplied m-tile by m-tile, k-step by k-step, each
// accumulator taking k-steps 0..7 in order from zero and each running max
// the n-tiles in order, so the outputs are the first design's bit for bit.
// What holds it, measured with patched builds of this design
// (scripts/exp_edgeconv_stage_variants.py --tf32; PERF.md row 2'), and what
// the design does about each against the first one (0.134-0.137 ms; each
// n-tile's next rows loaded right after its activation, the integer
// rounding rule, BN_a in registers):
// * the rounding: tf32_bits is seven integer instructions an element, at
//   half the FP32 issue rate, 0.037 ms of the kernel; the card's conversion
//   (tf32_rn: cvt.rn.tf32.f32, one F2FP) gives the same top 19 bits;
// * the shared reads, the largest cost left (without them, every m-tile
//   multiplied by m-tile 0's fragments, 0.068 ms): the first design's
//   compiled code already read each fragment once a unit (32 LDS.128,
//   reused over the n-tiles in registers, though the source names one a
//   product); here each lane keeps m-tile 0's 8 fragments in registers for
//   its walk and reads m-tiles 1-3's 24 once a unit, and BN_a's vectors
//   come from shared memory (32 registers a lane otherwise);
// * the registers: the next unit's rows and bvec are loaded once the
//   unit's last product is issued, not while its products run (80
//   registers in flight then), which is what pays for m-tile 0's
//   fragments.
// A unit's four n-tiles activated at once and multiplied m-tile by
// m-tile, each fragment then fed to four mma.sync in the source as well
// (the first design to try), needs 64 registers of fragments and ran
// slower at each step (PERF.md row 2').
// Resources (nvcc -Xptxas -v, sm_90a): 254 registers, no spill, 16,896
// bytes of shared memory; cuobjdump -sass: 128 HMMA, 64 F2FP and 40 LDS
// (8 of them BN_a's) in each of the loop's two instances, no GMMA.
// Extrema design. The kernel only gathers and compares, so what bounds it
// is the gather: B*N*k rows of 256 bytes (430 MB at B=8, N=7000, k=30) from
// a table (1.8 MB a cloud) that L2 holds. A warp takes a query, lane l its
// channels 2l and 2l + 1 (a gathered row is one coalesced 256-byte load),
// eight rows in flight, a running max and min per channel. Consecutive
// queries of a spatially ordered cloud share neighbours (at the default
// forward's stage 3, 64 consecutive queries name ~40% distinct rows), so
// each block takes a contiguous range of queries (one block of kXWarps
// warps an SM, the warps on neighbouring queries) and prefers L1 to shared
// memory: rows its warps share are read from L2 once more rarely. Rows
// come by the read-only path, the indices and bvec streamed past L1.
// (Deduplicating a tile's rows in shared memory and staging each once,
// measured on the card, lost: the hash, the staging and the fold of one
// tile could not overlap within an SM.) Max and min are exact in any
// order, and fmaxf / fminf skip a NaN row, so the outputs equal the first
// design's (a warp per query over a grid-stride of queries; a zero's sign
// may differ).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>

#include "knn_common.cuh"  // cp.async helpers

namespace {

constexpr int kC = 64;  // table / W2 width (every DGCNN EdgeConv stage)
constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
// stage kernel
constexpr int kUnitRows = 32;        // gathered rows a warp multiplies at once
constexpr int kRowStride = kC + 4;   // a staged row, in floats (17 float4)
constexpr int kRowStride4 = kRowStride / 4;
constexpr int kUnitFloats = (kUnitRows + 1) * kRowStride;  // 32 rows + bvec
constexpr int kMaxStageWarps = 12;
constexpr int kMaxBuffers = 2;
constexpr int kBfWarps = 8;  // bf16 stage kernel: warps a block at most, one block an SM
constexpr int kTfWarps = 8;  // TF32 stage kernel: likewise
constexpr int kXWarps = 32;  // extrema kernel: warps a block, one block an SM

// LeakyReLU, slope 0.2: the same bits as v >= 0 ? v : 0.2f * v (0.2f * v
// rounds to at most v for v >= 0 and at least v below 0), in two instructions
__device__ __forceinline__ float lrelu(float v) { return fmaxf(v, 0.2f * v); }

// (v * s) + t with two roundings, as the plain version computes it
__device__ __forceinline__ float affine(float v, float s, float t) {
  return __fadd_rn(__fmul_rn(v, s), t);
}

// A channel whose BN_b map v -> lrelu(affine(v, s, t)) is monotone
// without NaN for every finite or infinite v: s finite and non-zero, t
// finite (false for NaN).
__device__ __forceinline__ bool regular(float s, float t) {
  return fabsf(s) < INFINITY && s != 0.f && fabsf(t) < INFINITY;
}

// W2's column c is loaded negated where the channel is regular and its
// scale negative; the epilogue then uses the negated scale.
__device__ __forceinline__ bool flipped(const float* sb, const float* tb, int c) {
  return regular(sb[c], tb[c]) && sb[c] < 0.f;
}

size_t stage_smem_bytes(int warps, int nbuf) {
  return sizeof(float) * ((size_t)kC * kC + (size_t)warps * nbuf * kUnitFloats);
}

// A warp's unit of work: query q's rows 32c .. 32c + 31, staged in buffer
// `buf`. A warp's units run c = 0 .. nch - 1 of each of its queries q, q + G,
// q + 2G, ...; their buffers take turns.
struct Unit {
  int q, c, buf;
  __device__ __forceinline__ void advance(int nch, int G, int nbuf) {
    if (++c == nch) {
      c = 0;
      q += G;
    }
    if (++buf == nbuf) buf = 0;
  }
};

// The rows of unit (q, c): lane l loads the (clamped) neighbour index of
// row 32c + l, past k the last neighbour's. kStream: past L1 (the indices
// are read once; L1 is left to the gathered rows).
template <bool kStream = false>
__device__ __forceinline__ int unit_index(const int* __restrict__ idx, int q, int c, int K,
                                          int N, int lane) {
  const int j = min(c * kUnitRows + lane, K - 1);
  const int* p = idx + (size_t)q * K + j;
  const int nb = kStream ? __ldcs(p) : __ldg(p);
  return min(max(nb, 0), N - 1);
}

// cp.async of a unit's 32 rows (index of row r in lane r's `nb`) and the
// query's bvec row into `buf`, committed as one group.
__device__ __forceinline__ void stage_unit(float* buf, const float* __restrict__ tab,
                                           const float* __restrict__ bq, int nb, int lane) {
  const int c4 = lane & 15, half = lane >> 4;
#pragma unroll
  for (int i = 0; i < kUnitRows / 2; ++i) {
    const int r = half + 2 * i;
    const int row = __shfl_sync(kFull, nb, r);
    cp_async16(buf + r * kRowStride + 4 * c4, tab + (size_t)row * kC + 4 * c4, true);
  }
  if (lane < 16) cp_async16(buf + kUnitRows * kRowStride + 4 * lane, bq + 4 * lane, true);
  cp_async_commit();
}

__global__ void __launch_bounds__(kLanes * kMaxStageWarps, 1)
edgeconv_stage_kernel(const float* __restrict__ table,  // (B, N, 64)
                      const int* __restrict__ idx,      // (B, N, K)
                      const float* __restrict__ bvec,   // (B, N, 64)
                      const float* __restrict__ w2,     // (64, 64)
                      const float* __restrict__ sa, const float* __restrict__ ta,
                      const float* __restrict__ sb, const float* __restrict__ tb,
                      float* __restrict__ out,          // (B, N, 64)
                      int B, int N, int K, int nbuf) {
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);  // [64][64], some columns negated
  const int warps = blockDim.x / kLanes;
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  float* bufs = w2s + kC * kC + warp * nbuf * kUnitFloats;

  for (int t = threadIdx.x; t < kC * kC / 4; t += blockDim.x) {
    float4 w = reinterpret_cast<const float4*>(w2)[t];
    const int c = 4 * t % kC;
    if (flipped(sb, tb, c + 0)) w.x = -w.x;
    if (flipped(sb, tb, c + 1)) w.y = -w.y;
    if (flipped(sb, tb, c + 2)) w.z = -w.z;
    if (flipped(sb, tb, c + 3)) w.w = -w.w;
    reinterpret_cast<float4*>(w2s)[t] = w;
  }

  // transform: lane owns input channels 4 * c4 .. 4 * c4 + 3 of rows half + 2i
  const int c4 = lane & 15, half = lane >> 4;
  const float4 sa4 = reinterpret_cast<const float4*>(sa)[c4];
  const float4 ta4 = reinterpret_cast<const float4*>(ta)[c4];
  // product: rows rg + 4i, channels ch(j) = 4cg + j (j < 4), 32 + 4cg + j - 4
  const int rg = lane >> 3, cg = lane & 7;
  bool fast = true;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = (j < 4 ? 0 : 28) + 4 * cg + j;
    fast = fast && regular(sb[c], tb[c]);
  }
  __syncthreads();

  const int rows = B * N;  // at most INT_MAX / 8 (the launcher): q + 3G stays an int
  const int G = gridDim.x * warps;
  const int nch = (K + kUnitRows - 1) / kUnitRows;
  Unit cur{(int)blockIdx.x * warps + warp, 0, 0};  // the unit multiplied
  Unit st = cur;                                   // the next unit staged
  int nb = st.q < rows ? unit_index(idx, st.q, st.c, K, N, lane) : 0;  // st's rows
  // stage unit `st` (its indices in nb), then load the next unit's indices
  auto stage_next = [&]() {
    if (st.q < rows) {
      stage_unit(bufs + st.buf * kUnitFloats, table + (size_t)(st.q / N) * N * kC,
                 bvec + (size_t)st.q * kC, nb, lane);
    } else {
      cp_async_commit();  // an empty group keeps the count of groups in flight
    }
    st.advance(nch, G, nbuf);
    nb = st.q < rows ? unit_index(idx, st.q, st.c, K, N, lane) : 0;
  };
  for (int s = 0; s < nbuf - 1; ++s) stage_next();  // units 0 .. nbuf - 2 in flight

  float m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = -INFINITY;
  for (; cur.q < rows; cur.advance(nch, G, nbuf)) {
    stage_next();  // unit cur + nbuf - 1
    if (nbuf > 1) cp_async_wait<1>();  // unit cur + 1 may stay in flight
    else cp_async_wait<0>();
    __syncwarp();

    float* buf = bufs + cur.buf * kUnitFloats;
    float4* buf4 = reinterpret_cast<float4*>(buf);
    {  // bvec + BN_a + LeakyReLU, in place, once per element
      const float4 bv = buf4[kUnitRows * kRowStride4 + c4];
#pragma unroll 4
      for (int i = 0; i < kUnitRows / 2; ++i) {
        float4 v = buf4[(half + 2 * i) * kRowStride4 + c4];
        v.x = lrelu(affine(__fadd_rn(v.x, bv.x), sa4.x, ta4.x));
        v.y = lrelu(affine(__fadd_rn(v.y, bv.y), sa4.y, ta4.y));
        v.z = lrelu(affine(__fadd_rn(v.z, bv.z), sa4.z, ta4.z));
        v.w = lrelu(affine(__fadd_rn(v.w, bv.w), sa4.w, ta4.w));
        buf4[(half + 2 * i) * kRowStride4 + c4] = v;
      }
    }
    __syncwarp();

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    const float4* e4 = buf4 + rg * kRowStride4;
    const float4* w4 = reinterpret_cast<const float4*>(w2s) + cg;
#pragma unroll 2
    for (int dk = 0; dk < kC / 4; ++dk) {
      float4 e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = e4[4 * i * kRowStride4 + dk];
#pragma unroll
      for (int x = 0; x < 4; ++x) {  // input channel d = 4 dk + x, in order
        const float4 wa = w4[(4 * dk + x) * (kC / 4)];
        const float4 wb = w4[(4 * dk + x) * (kC / 4) + 8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ev = x == 0 ? e[i].x : x == 1 ? e[i].y : x == 2 ? e[i].z : e[i].w;
          acc[i][0] = fmaf(ev, wa.x, acc[i][0]);
          acc[i][1] = fmaf(ev, wa.y, acc[i][1]);
          acc[i][2] = fmaf(ev, wa.z, acc[i][2]);
          acc[i][3] = fmaf(ev, wa.w, acc[i][3]);
          acc[i][4] = fmaf(ev, wb.x, acc[i][4]);
          acc[i][5] = fmaf(ev, wb.y, acc[i][5]);
          acc[i][6] = fmaf(ev, wb.z, acc[i][6]);
          acc[i][7] = fmaf(ev, wb.w, acc[i][7]);
        }
      }
    }

    if (fast) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) m[j] = fmaxf(m[j], acc[i][j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = (j < 4 ? 0 : 28) + 4 * cg + j;
        const float sc = flipped(sb, tb, ch) ? -sb[ch] : sb[ch], sh = tb[ch];
#pragma unroll
        for (int i = 0; i < 8; ++i) m[j] = fmaxf(m[j], lrelu(affine(acc[i][j], sc, sh)));
      }
    }
    if (cur.c == nch - 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m[j] = fmaxf(m[j], __shfl_xor_sync(kFull, m[j], 8));
        m[j] = fmaxf(m[j], __shfl_xor_sync(kFull, m[j], 16));
        if (fast) {
          const int ch = (j < 4 ? 0 : 28) + 4 * cg + j;
          const float sc = flipped(sb, tb, ch) ? -sb[ch] : sb[ch];
          m[j] = lrelu(affine(m[j], sc, tb[ch]));
        }
      }
      if (rg == 0) {
        float4* o4 = reinterpret_cast<float4*>(out + (size_t)cur.q * kC);
        o4[cg] = make_float4(m[0], m[1], m[2], m[3]);
        o4[8 + cg] = make_float4(m[4], m[5], m[6], m[7]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j] = -INFINITY;
    }
    __syncwarp();  // the buffer is restaged by the next iteration
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// d += a b on the tensor cores: a 16 x 16 bf16 (row major), b 16 x 8 bf16
// (column major), d 16 x 8 FP32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (to nearest even), `lo` at the lower address
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Lane (g, t)'s share of a 64-channel row for the mma fragments: for each
// k-step s (channels 16s .. 16s + 15), channels 16s + 2t, 16s + 2t + 1
// (p[s][0]) and 16s + 2t + 8, 16s + 2t + 9 (p[s][1]), by the read-only path
// (kStream: past L1, for rows read once).
template <bool kStream = false>
__device__ __forceinline__ void load_share(float2 (&p)[4][2], const float* __restrict__ row,
                                           int t) {
  const float2* r2 = reinterpret_cast<const float2*>(row) + t;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    p[s][0] = kStream ? __ldcs(r2 + 8 * s) : __ldg(r2 + 8 * s);
    p[s][1] = kStream ? __ldcs(r2 + 8 * s + 4) : __ldg(r2 + 8 * s + 4);
  }
}

// bvec + BN_a (one FMA) + LeakyReLU in FP32 on two channels, rounded to
// bf16 and packed: one register of a B fragment
__device__ __forceinline__ uint32_t activate(float2 v, float2 b, float2 s, float2 h) {
  return pack_bf16(lrelu(fmaf(__fadd_rn(v.x, b.x), s.x, h.x)),
                   lrelu(fmaf(__fadd_rn(v.y, b.y), s.y, h.y)));
}

// A global read the compiler does not hoist out of the loop (the
// epilogue's rare per-row path would otherwise hold its BN_b vectors in
// registers for the whole kernel)
__device__ __forceinline__ float ld_in_place(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// The unit after (q, c) in a warp's walk: the query's next 32 rows, else
// the warp's next query, `step` queries on.
__device__ __forceinline__ void next_unit(int& q, int& c, int nch, int step) {
  if (++c == nch) {
    c = 0;
    q += step;
  }
}

// What the bf16 stage kernel's lane holds for the whole kernel: W2^T's A
// fragments (a[m][s]: output channels 16m + g, 16m + g + 8 at input
// channels 16s + 2t, +1, +8, +9, rounded to bf16, negated where flipped),
// BN_a at its 16 input channels, BN_b of the 2 channels it writes.
struct Bf16Lane {
  uint32_t a[4][4][4];
  float2 sa[4][2], ta[4][2];
  float osc[2], osh[2];
  int g, t, lane;
};

// A warp's walk over its queries q, q + step, ... below hi, a unit of 32
// rows at a time (k padded to a multiple of 32 by repeating the last
// neighbour, which leaves the max unchanged). kMaxFirst: every channel of
// BN_b is regular, so the running max is taken before BN_b; else BN_b and
// the LeakyReLU go on every row before the max. The loop body is one
// straight line (no branch between its n-tiles): the loads run a unit
// ahead, into the registers their n-tile was read from, on valid rows
// even past the warp's last unit.
template <bool kMaxFirst>
__device__ __forceinline__ void bf16_walk(const Bf16Lane& L, const float* __restrict__ table,
                                          const int* __restrict__ idx,
                                          const float* __restrict__ bvec,
                                          const float* __restrict__ sb,
                                          const float* __restrict__ tb, float* __restrict__ out,
                                          int N, int K, int q, int hi, int step) {
  const int g = L.g, t = L.t, lane = L.lane;
  const int nch = (K + kUnitRows - 1) / kUnitRows;
  // unit (q, c): its rows in x and its query's bvec in bv (in flight);
  // unit (q1, c1): its indices in nb1 (of query hi - 1 past the walk's end)
  int c = 0, q1 = q, c1 = 0;
  next_unit(q1, c1, nch, step);
  float2 x[4][4][2];  // n-tile j: lane (g, t)'s share of row 8j + g of the unit
  float2 bv[4][2];    // the unit's query's bvec at the lane's input channels
  {
    const int nb = unit_index<true>(idx, q, 0, K, N, lane);
    const float* tab = table + (size_t)(q / N) * N * kC;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      load_share(x[j], tab + (size_t)__shfl_sync(kFull, nb, 8 * j + g) * kC, t);
    load_share<true>(bv, bvec + (size_t)q * kC, t);
  }
  int nb1 = unit_index<true>(idx, min(q1, hi - 1), c1, K, N, lane);
  const unsigned long long nmagic = ~0ull / (unsigned)N + 1;  // ceil(2^64 / N) for N > 1

  float mx[4][2];  // running max over rows of channels 16m + g + 8h
#pragma unroll
  for (int m = 0; m < 4; ++m) mx[m][0] = mx[m][1] = -INFINITY;
  for (;;) {
    const bool more = q1 < hi;
    const int qv = more ? q1 : q;  // the next unit's query, else this one's: rows that exist
    int q2 = q1, c2 = c1;          // the unit after next: its indices
    next_unit(q2, c2, nch, step);
    const int nb2 = unit_index<true>(idx, min(q2, hi - 1), c2, K, N, lane);
    // qv's cloud, qv / N by a multiply (exact for qv < 2^32)
    const size_t cloud = N > 1 ? __umul64hi((unsigned long long)qv, nmagic) : qv;
    const float* tab1 = table + cloud * N * kC;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[4][2];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        b[s][0] = activate(x[j][s][0], bv[s][0], L.sa[s][0], L.ta[s][0]);
        b[s][1] = activate(x[j][s][1], bv[s][1], L.sa[s][1], L.ta[s][1]);
      }
      if (j == 3) load_share<true>(bv, bvec + (size_t)qv * kC, t);  // the next unit's bvec
      // the next unit's n-tile j, into the registers this one's was read from
      load_share(x[j], tab1 + (size_t)__shfl_sync(kFull, nb1, 8 * j + g) * kC, t);
      float d[4][4];  // output channels 16m + g (d[m][0..1]), + 8 (d[m][2..3]); rows 2t, 2t + 1
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        d[m][0] = d[m][1] = d[m][2] = d[m][3] = 0.f;
#pragma unroll
        for (int s = 0; s < 4; ++s) mma_bf16(d[m], L.a[m][s], b[s][0], b[s][1]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = d[m][2 * h], v1 = d[m][2 * h + 1];
          if (!kMaxFirst) {  // BN_b's vectors read where they are used: a rare path
            const int ch = 16 * m + g + 8 * h;
            const float s0 = ld_in_place(sb + ch), sh = ld_in_place(tb + ch);
            const float sc = regular(s0, sh) && s0 < 0.f ? -s0 : s0;  // as flipped
            v0 = lrelu(affine(v0, sc, sh));
            v1 = lrelu(affine(v1, sc, sh));
          }
          mx[m][h] = fmaxf(mx[m][h], fmaxf(v0, v1));
        }
    }
    // the max over t (lanes 4g .. 4g + 3) at every unit, which leaves a
    // running max as it is (max is idempotent), so that the loop has no
    // branch; at the query's last unit the outputs are written and the
    // running max reset
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[m][h] = fmaxf(mx[m][h], __shfl_xor_sync(kFull, mx[m][h], 1));
        mx[m][h] = fmaxf(mx[m][h], __shfl_xor_sync(kFull, mx[m][h], 2));
      }
    float o0 = mx[0][0], o1 = mx[0][1];
#pragma unroll
    for (int m = 1; m < 4; ++m)
      if (m == t) o0 = mx[m][0], o1 = mx[m][1];
    if (kMaxFirst)
      o0 = lrelu(affine(o0, L.osc[0], L.osh[0])), o1 = lrelu(affine(o1, L.osc[1], L.osh[1]));
    const bool last = c == nch - 1;  // the query's last unit
    if (last) {
      float* o = out + (size_t)q * kC + 16 * t + g;
      o[0] = o0;
      o[8] = o1;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) mx[m][h] = last ? -INFINITY : mx[m][h];
    if (!more) break;
    q = q1, c = c1, q1 = q2, c1 = c2, nb1 = nb2;
  }
}

__global__ void __launch_bounds__(kLanes * kBfWarps, 1)
edgeconv_stage_bf16_kernel(const float* __restrict__ table,  // (B, N, 64)
                           const int* __restrict__ idx,      // (B, N, K)
                           const float* __restrict__ bvec,   // (B, N, 64)
                           const float* __restrict__ w2,     // (64, 64)
                           const float* __restrict__ sa, const float* __restrict__ ta,
                           const float* __restrict__ sb, const float* __restrict__ tb,
                           float* __restrict__ out,          // (B, N, 64)
                           int B, int N, int K, int per) {
  const int warps = blockDim.x / kLanes;
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int g = lane >> 2, t = lane & 3;
  const int rows = B * N;  // at most INT_MAX / 8 (the launcher): q + 2 * warps stays an int
  const int lo = blockIdx.x * per, hi = min(rows, lo + per);  // this block's queries
  const int q = lo + warp;  // the warp's queries: q, q + warps, ... below hi
  if (q >= hi) return;  // the kernel has no barrier

  Bf16Lane L;
  L.g = g, L.t = t, L.lane = lane;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int c0 = 16 * m + g, c1 = c0 + 8;
    const bool f0 = flipped(sb, tb, c0), f1 = flipped(sb, tb, c1);
    auto w = [&](int d, int c, bool neg) {
      const float v = __ldg(w2 + d * kC + c);
      return neg ? -v : v;
    };
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int d = 16 * s + 2 * t;
      L.a[m][s][0] = pack_bf16(w(d, c0, f0), w(d + 1, c0, f0));
      L.a[m][s][1] = pack_bf16(w(d, c1, f1), w(d + 1, c1, f1));
      L.a[m][s][2] = pack_bf16(w(d + 8, c0, f0), w(d + 9, c0, f0));
      L.a[m][s][3] = pack_bf16(w(d + 8, c1, f1), w(d + 9, c1, f1));
    }
  }
  load_share(L.sa, sa, t);
  load_share(L.ta, ta, t);
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the two channels this lane writes, 16t + g + 8h
    const int ch = 16 * t + g + 8 * h;
    L.osc[h] = flipped(sb, tb, ch) ? -sb[ch] : sb[ch];
    L.osh[h] = tb[ch];
  }
  // the lane's 8 channels 16m + g + 8h regular; the warp's 64 all regular
  bool fast = true;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = 16 * m + g + 8 * h;
      fast = fast && regular(sb[ch], tb[ch]);
    }
  if (__all_sync(kFull, fast))
    bf16_walk<true>(L, table, idx, bvec, sb, tb, out, N, K, q, hi, warps);
  else
    bf16_walk<false>(L, table, idx, bvec, sb, tb, out, N, K, q, hi, warps);
}

// The extrema kernel: a warp per query, each block a contiguous range of
// queries, one block of kXWarps warps an SM (see the design note above).
__global__ void __launch_bounds__(kLanes * kXWarps, 1)
edgeconv_extrema_kernel(const float* __restrict__ table,  // (B, N, 64)
                        const int* __restrict__ idx,      // (B, N, K)
                        const float* __restrict__ bvec,   // (B, N, 64)
                        const float* __restrict__ gamma,  // (64,)
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        float* __restrict__ out,          // (B, N, 64)
                        int B, int N, int K) {
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int c = 2 * lane;
  const bool pos0 = gamma[c] >= 0.f, pos1 = gamma[c + 1] >= 0.f;
  const float2 s2 = *reinterpret_cast<const float2*>(scale + c);
  const float2 t2 = *reinterpret_cast<const float2*>(shift + c);
  const long long total = (long long)B * N;
  const long long per = (total + gridDim.x - 1) / gridDim.x;
  const long long lo = blockIdx.x * per, hi = min(total, lo + per);
  for (long long row = lo + warp; row < hi; row += kXWarps) {
    const long long b = row / N;
    const float* tab = table + (size_t)b * N * kC;
    const int* irow = idx + (size_t)row * K;
    float mx0 = -INFINITY, mx1 = -INFINITY, mn0 = INFINITY, mn1 = INFINITY;
    for (int j0 = 0; j0 < K; j0 += kLanes) {
      const int mine = __ldcs(irow + min(j0 + lane, K - 1));
      const int cnt = min(kLanes, K - j0);
#pragma unroll 8
      for (int jj = 0; jj < cnt; ++jj) {
        const int nb = min(max(__shfl_sync(kFull, mine, jj), 0), N - 1);
        const float2 g = __ldg(reinterpret_cast<const float2*>(tab + (size_t)nb * kC + c));
        mx0 = fmaxf(mx0, g.x);
        mx1 = fmaxf(mx1, g.y);
        mn0 = fminf(mn0, g.x);
        mn1 = fminf(mn1, g.y);
      }
    }
    const float2 bv = __ldcs(reinterpret_cast<const float2*>(bvec + (size_t)row * kC + c));
    const float sel0 = __fadd_rn(pos0 ? mx0 : mn0, bv.x);
    const float sel1 = __fadd_rn(pos1 ? mx1 : mn1, bv.y);
    *reinterpret_cast<float2*>(out + (size_t)row * kC + c) =
        make_float2(lrelu(affine(sel0, s2.x, t2.x)), lrelu(affine(sel1, s2.y, t2.y)));
  }
}

// d += a b on the tensor cores: a 16 x 8 TF32 (row major), b 8 x 8 TF32
// (column major), d 16 x 8 FP32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float4& a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)), "r"(__float_as_uint(a.z)),
        "r"(__float_as_uint(a.w)), "r"(b0), "r"(b1));
}

// v rounded to TF32 (ops/matmul.py::round_tf32): to nearest even on the 13
// low mantissa bits, the carry running into the exponent (past the largest
// finite value: inf); inf stays inf. A NaN becomes the canonical NaN.
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fffffffu;
  return (u + 0xfffu + ((u >> 13) & 1u)) & 0xffffe000u;
}

// v rounded to TF32 by the card's conversion (cvt.rn: to nearest even, past
// the largest finite value inf, a NaN a NaN): the top 19 bits, all the
// tensor cores read, are tf32_bits's for every v but a NaN whose payload
// lies in the low bits alone, which no result of arithmetic is (the card's
// arithmetic makes the canonical NaN). One instruction where tf32_bits
// takes seven integer ones.
__device__ __forceinline__ uint32_t tf32_rn(float v) {
  uint32_t r;
  asm("cvt.rn.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// Lane (g, t)'s share of a 64-channel row: p[i] = channels 16i + 4t ..
// 16i + 4t + 3 (kStream: past L1, for rows read once).
template <bool kStream = false>
__device__ __forceinline__ void load_share4(float4 (&p)[4], const float* __restrict__ row,
                                            int t) {
  const float4* r4 = reinterpret_cast<const float4*>(row) + t;
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = kStream ? __ldcs(r4 + 4 * i) : __ldg(r4 + 4 * i);
}

// What the TF32 stage kernel's lane holds for the whole kernel: where BN_a
// at its 16 input channels lies in shared memory (sa[4i], ta[4i]: channels
// 16i + 4t .. + 3; in registers they would take 32 a lane), BN_b of the 2
// channels it writes.
struct Tf32Lane {
  const float4* sa;
  const float4* ta;
  float osc[2], osh[2];
  int g, t, lane;
};

// The bf16 kernel's walk (bf16_walk) with TF32 fragments: w2f is W2^T in
// fragment order in shared memory, w2f[(8m + s) * 32 + lane] lane (g, t)'s
// A fragment of m-tile m at k-step s (see the design note above).
template <bool kMaxFirst>
__device__ __forceinline__ void tf32_walk(const Tf32Lane& L, const float4* __restrict__ w2f,
                                          const float* __restrict__ table,
                                          const int* __restrict__ idx,
                                          const float* __restrict__ bvec,
                                          const float* __restrict__ sb,
                                          const float* __restrict__ tb, float* __restrict__ out,
                                          int N, int K, int q, int hi, int step) {
  const int g = L.g, t = L.t, lane = L.lane;
  const int nch = (K + kUnitRows - 1) / kUnitRows;
  int c = 0, q1 = q, c1 = 0;
  next_unit(q1, c1, nch, step);
  float4 x[4][4];  // n-tile j: lane (g, t)'s share of row 8j + g of the unit
  float4 bv[4];    // the unit's query's bvec at the lane's input channels
  {
    const int nb = unit_index<true>(idx, q, 0, K, N, lane);
    const float* tab = table + (size_t)(q / N) * N * kC;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      load_share4(x[j], tab + (size_t)__shfl_sync(kFull, nb, 8 * j + g) * kC, t);
    load_share4<true>(bv, bvec + (size_t)q * kC, t);
  }
  int nb1 = unit_index<true>(idx, min(q1, hi - 1), c1, K, N, lane);
  const unsigned long long nmagic = ~0ull / (unsigned)N + 1;  // ceil(2^64 / N) for N > 1
  float4 w0[8];  // m-tile 0's A fragments, read from shared memory once for the walk
#pragma unroll
  for (int s = 0; s < 8; ++s) w0[s] = w2f[s * kLanes + lane];

  float mx[4][2];  // running max over rows of channels 16m + g + 8h
#pragma unroll
  for (int m = 0; m < 4; ++m) mx[m][0] = mx[m][1] = -INFINITY;
  for (;;) {
    const bool more = q1 < hi;
    const int qv = more ? q1 : q;  // the next unit's query, else this one's: rows that exist
    int q2 = q1, c2 = c1;          // the unit after next: its indices
    next_unit(q2, c2, nch, step);
    const int nb2 = unit_index<true>(idx, min(q2, hi - 1), c2, K, N, lane);
    const size_t cloud = N > 1 ? __umul64hi((unsigned long long)qv, nmagic) : qv;
    const float* tab1 = table + cloud * N * kC;
    // n-tile by n-tile: its rows activated and rounded, then multiplied
    // m-tile by m-tile, k-step by k-step; each accumulator takes k-steps
    // 0..7 in order from zero, each running max the n-tiles in order
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[8][2];  // k-step 2i + v: channels 16i + 4t + 2v (k row t), + 1 (k row t + 4)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = x[j][i], bb = bv[i], s = L.sa[4 * i], h = L.ta[4 * i];
        b[2 * i][0] = tf32_rn(lrelu(affine(__fadd_rn(v.x, bb.x), s.x, h.x)));
        b[2 * i][1] = tf32_rn(lrelu(affine(__fadd_rn(v.y, bb.y), s.y, h.y)));
        b[2 * i + 1][0] = tf32_rn(lrelu(affine(__fadd_rn(v.z, bb.z), s.z, h.z)));
        b[2 * i + 1][1] = tf32_rn(lrelu(affine(__fadd_rn(v.w, bb.w), s.w, h.w)));
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        // channels 16m + g (d[0..1]), + 8 (d[2..3]); rows 2t, 2t + 1
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < 8; ++s)
          mma_tf32(d, m == 0 ? w0[s] : w2f[(8 * m + s) * kLanes + lane], b[s][0], b[s][1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = d[2 * h], v1 = d[2 * h + 1];
          if (!kMaxFirst) {  // BN_b's vectors read where they are used: a rare path
            const int ch = 16 * m + g + 8 * h;
            const float s0 = ld_in_place(sb + ch), sh = ld_in_place(tb + ch);
            const float sc = regular(s0, sh) && s0 < 0.f ? -s0 : s0;  // as flipped
            v0 = lrelu(affine(v0, sc, sh));
            v1 = lrelu(affine(v1, sc, sh));
          }
          mx[m][h] = fmaxf(mx[m][h], fmaxf(v0, v1));
        }
      }
    }
    // the next unit's rows and bvec, loaded once the products are issued:
    // while those run, x's 64 registers are free
    load_share4<true>(bv, bvec + (size_t)qv * kC, t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      load_share4(x[j], tab1 + (size_t)__shfl_sync(kFull, nb1, 8 * j + g) * kC, t);
    // the max over t, the write at the query's last unit: as bf16_walk
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[m][h] = fmaxf(mx[m][h], __shfl_xor_sync(kFull, mx[m][h], 1));
        mx[m][h] = fmaxf(mx[m][h], __shfl_xor_sync(kFull, mx[m][h], 2));
      }
    float o0 = mx[0][0], o1 = mx[0][1];
#pragma unroll
    for (int m = 1; m < 4; ++m)
      if (m == t) o0 = mx[m][0], o1 = mx[m][1];
    if (kMaxFirst)
      o0 = lrelu(affine(o0, L.osc[0], L.osh[0])), o1 = lrelu(affine(o1, L.osc[1], L.osh[1]));
    const bool last = c == nch - 1;
    if (last) {
      float* o = out + (size_t)q * kC + 16 * t + g;
      o[0] = o0;
      o[8] = o1;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) mx[m][h] = last ? -INFINITY : mx[m][h];
    if (!more) break;
    q = q1, c = c1, q1 = q2, c1 = c2, nb1 = nb2;
  }
}

__global__ void __launch_bounds__(kLanes * kTfWarps, 1)
edgeconv_stage_tf32_kernel(const float* __restrict__ table,  // (B, N, 64)
                           const int* __restrict__ idx,      // (B, N, K)
                           const float* __restrict__ bvec,   // (B, N, 64)
                           const float* __restrict__ w2,     // (64, 64)
                           const float* __restrict__ sa, const float* __restrict__ ta,
                           const float* __restrict__ sb, const float* __restrict__ tb,
                           float* __restrict__ out,          // (B, N, 64)
                           int B, int N, int K, int per) {
  // W2^T's A fragments (m16n8k8 tf32: a0 (row g, col t), a1 (g + 8, t), a2
  // (g, t + 4), a3 (g + 8, t + 4)), rounded to TF32, negated where flipped
  __shared__ float4 w2f[4 * 8 * kLanes];
  __shared__ float4 bn_a[2 * kC / 4];  // BN_a's scale, then its shift
  if (threadIdx.x < 2 * kC / 4)
    bn_a[threadIdx.x] = __ldg(reinterpret_cast<const float4*>(threadIdx.x < kC / 4 ? sa : ta) +
                              threadIdx.x % (kC / 4));
  for (int i = threadIdx.x; i < 4 * 8 * kLanes; i += blockDim.x) {
    const int l = i % kLanes, m = i / kLanes / 8, s = i / kLanes % 8;
    const int g = l >> 2, t = l & 3;
    const int d = 16 * (s >> 1) + 4 * t + 2 * (s & 1);  // k row t; k row t + 4 is d + 1
    const int c0 = 16 * m + g, c1 = c0 + 8;
    const bool f0 = flipped(sb, tb, c0), f1 = flipped(sb, tb, c1);
    auto w = [&](int dd, int cc, bool neg) {
      const float v = __ldg(w2 + dd * kC + cc);
      return __uint_as_float(tf32_bits(neg ? -v : v));
    };
    w2f[i] = make_float4(w(d, c0, f0), w(d, c1, f1), w(d + 1, c0, f0), w(d + 1, c1, f1));
  }
  __syncthreads();
  const int warps = blockDim.x / kLanes;
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int g = lane >> 2, t = lane & 3;
  const int rows = B * N;  // at most INT_MAX / 8 (the launcher): q + 2 * warps stays an int
  const int lo = blockIdx.x * per, hi = min(rows, lo + per);  // this block's queries
  const int q = lo + warp;  // the warp's queries: q, q + warps, ... below hi
  if (q >= hi) return;  // no barrier follows

  Tf32Lane L;
  L.g = g, L.t = t, L.lane = lane;
  L.sa = bn_a + t;
  L.ta = bn_a + kC / 4 + t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the two channels this lane writes, 16t + g + 8h
    const int ch = 16 * t + g + 8 * h;
    L.osc[h] = flipped(sb, tb, ch) ? -sb[ch] : sb[ch];
    L.osh[h] = tb[ch];
  }
  bool fast = true;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = 16 * m + g + 8 * h;
      fast = fast && regular(sb[ch], tb[ch]);
    }
  if (__all_sync(kFull, fast))
    tf32_walk<true>(L, w2f, table, idx, bvec, sb, tb, out, N, K, q, hi, warps);
  else
    tf32_walk<false>(L, w2f, table, idx, bvec, sb, tb, out, N, K, q, hi, warps);
}

}  // namespace

// table/bvec/out (B,N,64), idx (B,N,K) int32, w2 (64,64) row-major
// (input channel major), sa/ta/sb/tb (64,). Launch geometry: `warps` per
// block (1..12), `nbuf` staging buffers per warp (1..2), `grid` blocks (0:
// as many as fit on the device's SMs at once; at most one warp per query
// either way). Returns a cudaError_t.
extern "C" int dgcnn_edgeconv_stage(const float* table, const int* idx,
                                    const float* bvec, const float* w2,
                                    const float* sa, const float* ta,
                                    const float* sb, const float* tb,
                                    float* out, int B, int N, int K, int warps,
                                    int nbuf, int grid, void* stream) {
  if (K < 1 || warps < 1 || warps > kMaxStageWarps || nbuf < 1 || nbuf > kMaxBuffers ||
      grid < 0)
    return cudaErrorInvalidValue;
  const long long rows = (long long)B * N;
  if (rows == 0) return cudaSuccess;
  if (rows > INT_MAX / 8) return cudaErrorInvalidValue;  // query numbers are ints
  const size_t smem = stage_smem_bytes(warps, nbuf);
  cudaError_t err = cudaFuncSetAttribute(
      edgeconv_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  long long blocks = grid;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, edgeconv_stage_kernel,
                                                        kLanes * warps, smem);
    if (err != cudaSuccess) return err;
    blocks = (long long)std::max(per_sm, 1) * sms;
  }
  blocks = std::min(blocks, (rows + warps - 1) / warps);
  edgeconv_stage_kernel<<<(unsigned)blocks, kLanes * warps, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      table, idx, bvec, w2, sa, ta, sb, tb, out, B, N, K, nbuf);
  return cudaGetLastError();
}

// The bf16 stage kernel: the arguments of dgcnn_edgeconv_stage; `warps`
// a block (1..8) and `per` queries a block, each block a contiguous range
// (ceil(B*N / per) blocks). Returns a cudaError_t.
extern "C" int dgcnn_edgeconv_stage_bf16(const float* table, const int* idx,
                                         const float* bvec, const float* w2,
                                         const float* sa, const float* ta,
                                         const float* sb, const float* tb,
                                         float* out, int B, int N, int K, int warps,
                                         int per, void* stream) {
  if (K < 1 || warps < 1 || warps > kBfWarps || per < 1) return cudaErrorInvalidValue;
  const long long rows = (long long)B * N;
  if (rows == 0) return cudaSuccess;
  if (rows > INT_MAX / 8) return cudaErrorInvalidValue;  // query numbers are ints
  per = (int)std::min<long long>(per, rows);
  // all of the SM's on-chip memory as L1: the kernel takes no shared memory
  cudaError_t err = cudaFuncSetAttribute(edgeconv_stage_bf16_kernel,
                                         cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (err != cudaSuccess) return err;
  edgeconv_stage_bf16_kernel<<<(unsigned)((rows + per - 1) / per), kLanes * warps, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      table, idx, bvec, w2, sa, ta, sb, tb, out, B, N, K, per);
  return cudaGetLastError();
}

// The TF32 stage kernel: the arguments of dgcnn_edgeconv_stage_bf16; `warps`
// a block (1..8) and `per` queries a block. Returns a cudaError_t.
extern "C" int dgcnn_edgeconv_stage_tf32(const float* table, const int* idx,
                                         const float* bvec, const float* w2,
                                         const float* sa, const float* ta,
                                         const float* sb, const float* tb,
                                         float* out, int B, int N, int K, int warps,
                                         int per, void* stream) {
  if (K < 1 || warps < 1 || warps > kTfWarps || per < 1) return cudaErrorInvalidValue;
  const long long rows = (long long)B * N;
  if (rows == 0) return cudaSuccess;
  if (rows > INT_MAX / 8) return cudaErrorInvalidValue;  // query numbers are ints
  per = (int)std::min<long long>(per, rows);
  // as much of the SM's on-chip memory as L1 as W2's 16 KB leave
  cudaError_t err = cudaFuncSetAttribute(edgeconv_stage_tf32_kernel,
                                         cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (err != cudaSuccess) return err;
  edgeconv_stage_tf32_kernel<<<(unsigned)((rows + per - 1) / per), kLanes * warps, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      table, idx, bvec, w2, sa, ta, sb, tb, out, B, N, K, per);
  return cudaGetLastError();
}

// table/bvec/out (B,N,64), idx (B,N,K) int32, gamma/scale/shift (64,).
// `grid` blocks, each a contiguous range of queries (0: one an SM). Returns
// a cudaError_t.
extern "C" int dgcnn_edgeconv_extrema(const float* table, const int* idx,
                                      const float* bvec, const float* gamma,
                                      const float* scale, const float* shift,
                                      float* out, int B, int N, int K, int grid,
                                      void* stream) {
  if (K < 1 || grid < 0) return cudaErrorInvalidValue;
  const long long rows = (long long)B * N;
  if (rows == 0) return cudaSuccess;
  // all of the SM's on-chip memory as L1: the kernel takes no shared memory
  cudaError_t err = cudaFuncSetAttribute(edgeconv_extrema_kernel,
                                         cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (err != cudaSuccess) return err;
  long long blocks = grid;
  if (blocks == 0) {
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    blocks = sms;
  }
  blocks = std::min(blocks, rows);
  edgeconv_extrema_kernel<<<(unsigned)blocks, kLanes * kXWarps, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      table, idx, bvec, gamma, scale, shift, out, B, N, K);
  return cudaGetLastError();
}
