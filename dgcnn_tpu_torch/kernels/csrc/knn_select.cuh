// What the two-phase kNN kernels share (knn_banded.cu, knn_capped.cu,
// knn_packed.cu and knn_exact_banded.cu): the packed key of a (query,
// row) pair, the sorted per-window lists, the 8 x 8 register tile of
// dots, the staging of a block's queries, and the merges of the lists
// into the top-k (by packed key, or by (key, row) for the exact banded
// kernel, whose keys repeat).
//
//   score(q, o) = (2 * <x_o, q> - |x_o|^2) - |q|^2       (FP32, FMA dot)
//   key         = monotone_int(score) >> 1, low idx_bits replaced by a
//                 row label that is unique per query
//
// Every dot is one fmaf chain over channels 0..CV-1 from 0.f, so a kernel
// that scores with these functions computes the same keys bit for bit,
// whatever order it visits the rows in. The keys are unique, so the
// per-window top-cap and the merge are functions of the keys alone.

#pragma once

#include <cuda_runtime.h>
#include <climits>

#include "knn_common.cuh"  // score_key, cp.async helpers

// A staged row's stride in float4: odd, so that 8 consecutive rows fall in
// 8 different 16-byte bank groups.
template <int CV>
__host__ __device__ constexpr int row_stride4() {
  return (CV / 4) % 2 ? CV / 4 : CV / 4 + 1;
}

__device__ __forceinline__ int pack_key(float s, int low, int keep_mask) {
  return ((score_key(s) >> 1) & keep_mask) | low;
}

// explicit roundings: (2*dot - |x|^2) - |q|^2, as the TPU kernel
__device__ __forceinline__ float score(float dot, float xn, float qn) {
  return __fsub_rn(__fsub_rn(__fmul_rn(2.f, dot), xn), qn);
}

// v into a list sorted largest first (CAP keys); keys are unique, and
// INT_MIN (an empty slot, or a slot past n_win) changes nothing
template <int CAP>
__device__ __forceinline__ void insert(int (&top)[CAP], int v) {
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    const int hi = max(top[i], v);
    v = min(top[i], v);
    top[i] = hi;
  }
}

// The queries q0 .. q0 + qb - 1 of a (rows, CV) table (clamped to rows - 1),
// by cp.async into rows of stride row_stride4, uncommitted.
template <int CV>
__device__ __forceinline__ void stage_queries(float4* qs4, const float* qb_rows, int q0,
                                              int qb, int rows) {
  constexpr int V = CV / 4, XS4 = row_stride4<CV>();
  for (int t = threadIdx.x; t < qb * V; t += blockDim.x) {
    const int ql = t / V, c4 = t % V;
    const int qi = min(q0 + ql, rows - 1);
    cp_async16(qs4 + ql * XS4 + c4, qb_rows + (size_t)qi * CV + 4 * c4, true);
  }
}

// Unroll of the 2-channel steps of tile_dots' loop.
constexpr int kC2Unroll = 4;

// The 8 x 8 dots of staged queries ty + TY * a and staged rows tx + RS * c
// (both in rows of stride row_stride4), two channels a read: every float
// read from shared memory feeds 4 FMAs. Each accumulator's chain runs
// channel after channel from 0.f. UNROLL: 2-channel steps unrolled (a
// kernel that keeps many registers live across the call unrolls less).
template <int CV, int RS = 32, int UNROLL = kC2Unroll>
__device__ __forceinline__ void tile_dots(float (&acc)[8][8], const float4* __restrict__ qs4,
                                          const float4* __restrict__ xs4, int ty, int TY,
                                          int tx) {
  constexpr int XS2 = 2 * row_stride4<CV>();
  const float2* q2 = reinterpret_cast<const float2*>(qs4) + ty * XS2;
  const float2* x2 = reinterpret_cast<const float2*>(xs4) + tx * XS2;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
#pragma unroll (UNROLL)
  for (int c2 = 0; c2 < CV / 2; ++c2) {
    float2 qf[8], xf[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) qf[a] = q2[a * TY * XS2 + c2];
#pragma unroll
    for (int c = 0; c < 8; ++c) xf[c] = x2[c * RS * XS2 + c2];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(qf[a].x, xf[c].x, acc[a][c]);
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(qf[a].y, xf[c].y, acc[a][c]);
  }
}

// One pass of merge_lists' one-round merge: queries q0 + base + warp +
// nwarps * m, m < G (kBatched: those at or past qb skipped).
template <int CAP, int G, bool kBatched>
__device__ __forceinline__ void merge_heads(const int* lists, int base, int qb, int q0, int b,
                                            int M, int K, int n_win, int start, int band,
                                            int imask, int* __restrict__ out,
                                            int* __restrict__ kth) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int LS = CAP + 1;
  int h0[G], h1[G], p0[G], p1[G], res[G], last[G];
#pragma unroll
  for (int m = 0; m < G; ++m) {
    const int ql = kBatched ? min(base + warp + nwarps * m, qb - 1) : warp + nwarps * m;
    const int lb = ql * n_win * LS;
    p0[m] = lb + (lane < n_win ? lane * LS : CAP);
    p1[m] = lb + (lane + 32 < n_win ? (lane + 32) * LS : CAP);
    h0[m] = lists[p0[m]];
    h1[m] = lists[p1[m]];
    res[m] = last[m] = INT_MIN;
  }
  for (int t = 0; t < K; ++t) {
#pragma unroll
    for (int m = 0; m < G; ++m) {
      const int best = __reduce_max_sync(0xffffffffu, max(h0[m], h1[m]));
      res[m] = lane == (t & 31) ? best : res[m];
      last[m] = best;
      const bool real = best != INT_MIN;
      p0[m] += real && h0[m] == best;
      p1[m] += real && h1[m] == best;
      h0[m] = lists[p0[m]];
      h1[m] = lists[p1[m]];
    }
    if ((t & 31) == 31 || t == K - 1) {  // warp-uniform
#pragma unroll
      for (int m = 0; m < G; ++m) {
        const int ql = base + warp + nwarps * m;
        const int qq = q0 + ql;
        if ((!kBatched || ql < qb) && qq < M && lane <= (t & 31))
          out[((size_t)b * M + qq) * K + (t & ~31) + lane] = start + band - 1 - (res[m] & imask);
      }
    }
  }
  if (!kBatched || kth != nullptr) {
#pragma unroll
    for (int m = 0; m < G; ++m) {
      const int ql = base + warp + nwarps * m;
      const int qq = q0 + ql;
      if (K > 0 && (!kBatched || ql < qb) && qq < M && lane == 0)
        kth[(size_t)b * M + qq] = last[m];
    }
  }
}

// The merge of the per-window lists ([qb][n_win][LS], sorted largest
// first) into each query's top-k, largest key first, written as the row
// `start + band - 1 - (key & imask)` to out[(b * M + q) * K ..], and its
// k-th key to kth[b * M + q]; queries q0 + ql, ql < qb, those past M
// skipped. One round of windows (n_win <= 64, LS = CAP + 1, a sentinel
// INT_MIN closing each list): each lane holds the heads of windows lane
// and lane + 32; k rounds of a warp max pop the winners in order (keys
// are unique; INT_MIN is an exhausted list, a window shorter than CAP, or
// no window). Branch-free, so that the G queries a warp merges at once
// overlap their rounds: a lane without a window points at a sentinel, and
// a pop moves a pointer that stays in its list. Several rounds (n_win >
// 64, LS = CAP): k rounds of "largest key below the last winner" over
// every slot. kBatched: qb may differ from G * nwarps (the block takes G *
// nwarps queries a pass) and kth may be null; without it the banded
// kernel's merge, instruction for instruction.
template <int CAP, int G, bool kBatched = false>
__device__ __forceinline__ void merge_lists(const int* lists, bool one_round, int qb,
                                            int q0, int b, int M, int K, int n_win,
                                            int start, int band, int imask,
                                            int* __restrict__ out,
                                            int* __restrict__ kth) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (one_round) {
    if constexpr (kBatched) {
      for (int base = 0; base < qb; base += G * nwarps)
        merge_heads<CAP, G, true>(lists, base, qb, q0, b, M, K, n_win, start, band, imask,
                                  out, kth);
    } else {
      merge_heads<CAP, G, false>(lists, 0, qb, q0, b, M, K, n_win, start, band, imask, out,
                                 kth);
    }
    return;
  }
  const int LS = CAP;
  for (int ql = warp; ql < qb; ql += nwarps) {
    const int qq = q0 + ql;
    if (qq >= M) break;  // warp-uniform
    const int* keys = lists + ql * n_win * LS;
    int* orow = out + ((size_t)b * M + qq) * K;
    int prev = INT_MAX;
    for (int t = 0; t < K; ++t) {
      int best = INT_MIN;
      for (int w = lane; w < n_win; w += 32)
#pragma unroll
        for (int i = 0; i < CAP; ++i) {
          const int v = keys[w * LS + i];
          if (v < prev && v > best) best = v;
        }
      best = __reduce_max_sync(0xffffffffu, best);
      if (lane == 0) orow[t] = start + band - 1 - (best & imask);
      prev = best;
    }
    if ((!kBatched || kth != nullptr) && lane == 0) kth[(size_t)b * M + qq] = prev;
  }
}

// (k, r) ranks before (ok, orr): the larger key first, then the lower row
// (the exact banded kernel's order: its keys repeat).
__device__ __forceinline__ bool ahead(int k, int r, int ok, int orr) {
  return k > ok || (k == ok && r < orr);
}

// (v, s) into a list of (key, row) pairs sorted largest key first, whose
// candidates arrive in ascending row order: the candidate goes before the
// first entry of a strictly smaller key (so among equal keys the earlier
// row stays ahead and the list keeps the (key desc, row asc) order), and
// every entry from there on moves down one slot; a candidate that beats
// no entry changes nothing. Each slot is computed from the old list alone
// (no value carried from slot to slot): its key is max(key, min(key
// above, v)), its row follows the compares of v with the old keys.
template <int CAP>
__device__ __forceinline__ void insert_pair(int (&tk)[CAP], int (&ts)[CAP], int v, int s) {
  bool sw[CAP];  // v passes slot i: true from the candidate's slot on
#pragma unroll
  for (int i = 0; i < CAP; ++i) sw[i] = v > tk[i];
#pragma unroll
  for (int i = CAP - 1; i > 0; --i) {  // back to front: slot i - 1 still old
    tk[i] = max(tk[i], min(tk[i - 1], v));
    ts[i] = sw[i] ? (sw[i - 1] ? ts[i - 1] : s) : ts[i];
  }
  tk[0] = max(tk[0], v);
  ts[0] = sw[0] ? s : ts[0];
}

// The lexicographic merge of the exact banded kernel: per query, the
// top-k in (key desc, row asc) order of its n_win <= 64 window lists
// ([qb][n_win][CAP + 1] keys in `lkeys`, in-window rows s in `lrows`, each
// list in that order and closed by an INT_MIN sentinel; window w's row s
// is band row s * n_win + w). Each lane holds the heads of windows lane
// and lane + 32; a round takes the warp's largest head key
// (__reduce_max_sync), then the lowest row among the heads of that key
// (__reduce_min_sync), and pops it. Writes `start` + each winner's row to
// out[(b * N + q) * K ..], the k-th winner's key to kth[b * N + q], and
// ovf[b * N + q] = (the largest of the windows' cap-th keys) >= that key.
// Warp w merges queries w + nwarps * m, m < G, their rounds interleaved;
// queries past N are skipped. Real keys exceed INT_MIN and at least k
// real entries exist (n_win * min(cap, rows a window) >= k), so no
// sentinel and no empty slot of a short window ever wins.
template <int CAP, int G>
__device__ __forceinline__ void merge_lists_lex(const int* __restrict__ lkeys,
                                                const unsigned short* __restrict__ lrows,
                                                int q0, int b, int N, int K, int n_win,
                                                int start, int* __restrict__ out,
                                                int* __restrict__ kth, int* __restrict__ ovf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int LS = CAP + 1;
  const int w0 = lane, w1 = lane + 32;
  int p0[G], p1[G], k0[G], k1[G], r0[G], r1[G], res[G], last[G], capm[G];
#pragma unroll
  for (int m = 0; m < G; ++m) {
    const int lb = (warp + nwarps * m) * n_win * LS;
    const int c0 = w0 < n_win ? lkeys[lb + w0 * LS + CAP - 1] : INT_MIN;
    const int c1 = w1 < n_win ? lkeys[lb + w1 * LS + CAP - 1] : INT_MIN;
    capm[m] = __reduce_max_sync(0xffffffffu, max(c0, c1));
    p0[m] = lb + (w0 < n_win ? w0 * LS : CAP);  // no window: window 0's sentinel
    p1[m] = lb + (w1 < n_win ? w1 * LS : CAP);
    k0[m] = lkeys[p0[m]];
    r0[m] = lrows[p0[m]] * n_win + w0;
    k1[m] = lkeys[p1[m]];
    r1[m] = lrows[p1[m]] * n_win + w1;
    res[m] = last[m] = INT_MIN;
  }
  for (int t = 0; t < K; ++t) {
#pragma unroll
    for (int m = 0; m < G; ++m) {
      const bool first = ahead(k0[m], r0[m], k1[m], r1[m]);
      const int hk = first ? k0[m] : k1[m], hr = first ? r0[m] : r1[m];
      const int bk = __reduce_max_sync(0xffffffffu, hk);
      const int br = __reduce_min_sync(0xffffffffu, hk == bk ? hr : INT_MAX);
      res[m] = lane == (t & 31) ? br : res[m];
      last[m] = bk;
      p0[m] += k0[m] == bk && r0[m] == br;
      p1[m] += k1[m] == bk && r1[m] == br;
      k0[m] = lkeys[p0[m]];
      r0[m] = lrows[p0[m]] * n_win + w0;
      k1[m] = lkeys[p1[m]];
      r1[m] = lrows[p1[m]] * n_win + w1;
    }
    if ((t & 31) == 31 || t == K - 1) {  // warp-uniform
#pragma unroll
      for (int m = 0; m < G; ++m) {
        const int qq = q0 + warp + nwarps * m;
        if (qq < N && lane <= (t & 31))
          out[((size_t)b * N + qq) * K + (t & ~31) + lane] = start + res[m];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < G; ++m) {
    const int qq = q0 + warp + nwarps * m;
    if (K > 0 && qq < N && lane == 0) {
      kth[(size_t)b * N + qq] = last[m];
      ovf[(size_t)b * N + qq] = capm[m] >= last[m] ? 1 : 0;
    }
  }
}
