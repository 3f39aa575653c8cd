"""Smoke test of the PyTorch + CUDA port (dgcnn_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. device and toolchain: the card, its power limit, torch / CUDA / nvcc
   versions; builds the CUDA kernels from the sources in this checkout
   (one nvcc per source, all at once);
2. every kernel of the serving paths against its plain PyTorch version,
   on the card, at the main path's shapes (B=8, N=7000, k=30; C=4 for the
   stage-1 kNN, C=64 otherwise; bands 2048 / 4096, 64 windows, cap 6),
   with median times of both: capped kNN, fused stage and extrema, banded
   kNN, exact kNN (256 random integer queries; the stage-1 repair's own
   call in the default forward, its 256 queries per cloud with their rows
   as the kernel's hint; a 40000-row self-kNN, the capped kNN's fallback
   past 15 index bits); then the banded wrappers on
   the card: a forced repair, an unsorted batch, a recall-guard trip;
3. the capped-only serving path (``knn_impl="pallas_capped"``, bands 0):
   a seeded full-width checkpoint in the JAX package's .npz layout and
   one synthetic LAS tile, classified by the port's PredictService
   through serve_directory(once=True), with the kernels' launch counters
   reset before and read after;
4. the default serving path (no kNN arguments: ``auto``, bands
   2048 / 4096, the amortized recall guard): three tiles and one
   270 m x 240 m tile of 9 batches, so guarded and unguarded dispatches
   both run, with the launch counts asserted;
5. no host sync: guarded and unguarded predict steps and one forward of
   the default configuration under ``torch.cuda.set_sync_debug_mode``
   ("error");
6. the forward: the default configuration on the GPU against the CPU
   plain versions of the same banded path, and the capped-only, parity
   and packed ones likewise; times of the default forward (guarded and
   unguarded dispatches) and of the capped-only, parity and packed
   forwards;
7. training (the second path): 20 synthetic 30 m rooms of 12 000 points
   from a seed; the port's ``train()`` at full width in the production
   configuration (B=8, N=7000, k=30, emb 1024, dropout 0.5, Adam, the
   default bands and recall guard) for 2 epochs, with the launch counts
   asserted (per train step 3 ``gather_rows``, the forward's neighbour
   gathers; 1 ``scatter_add_rows``, stage 2's gather VJP — stage 1
   gathers the input points, which need no gradient, so autograd never
   runs that backward —; 1 ``scatter_stage_tail_rows``; 3 banded kNNs);
   20 steps on one fixed batch (the loss falls; the median step time of
   the last 10, each with its ``float(loss)`` read; the peak device
   memory); one step's
   gradients on the GPU against the CPU plain versions at (2, 2048), the
   CPU replaying the card's neighbour indices; one tile served from the
   checkpoint the trainer wrote; then 10 steps in the parity mode
   (``knn_impl="pallas"``) on the same batch, with the launch counts per
   step asserted, the loss, the median step time and the peak memory;
   then ``train(..., device_masks=True)`` for 5 steps, class 4 excluded:
   each class-balance mask drawn on the card holds m points of every
   considered class and none of class 4, and equals the CPU plain
   version's on the same uniforms; the losses are finite;
8. evaluation (the third path): ``python -m dgcnn_tpu_torch.train --eval
   1`` in-process on phase 7's checkpoint and rooms at full width (two
   batches of 8), the dumps and metrics against the same ``test()`` on the
   CPU plain versions, and a forced recall-guard trip over both batches
   against a run on the full capped kernel;
9. the offline lifecycle through the port's command line
   (``dgcnn_tpu_torch.__main__``, in-process, ``--device cuda`` by
   default): ``--mode process_data`` on a 110 m tile of
   ``scripts/torch_full_pipeline.py``'s scene (at least 16 rooms; which
   DTM path ran is printed), 2 epochs of training at full width, ``--eval
   1`` with its dumps, the post-processing (``export_dir``,
   ``process_dir``, ``combine_dirs``, ``evaluate_combined_dir``),
   ``--predict`` on the tile and on a directory of two tiles with
   ``--classify_all 1`` (every loaded point classified), and the
   environment report (``utils/report.py``); each stage's time printed,
   the launch counters reset before and read after (the banded kNN, the
   stage and extrema, gather, row-scatter and tail kernels all launched;
   each kernel's row in the JSON line carries its count as
   ``lifecycle_launches``).

The parity mode (``knn_impl="pallas"``: the exact banded kNN, stage 1 at
band 2048, stages 2-3 at full width, 64 windows, cap 8) and the packed
mode (``knn_impl="pallas_packed"``: the flat packed kNN) run in phase 2
(each kernel against its plain version, timed by ``cuda_ms_many``: the
exact banded kernel at C=4 band 2048 and C=64 full width, bit for bit in
its three outputs on a 1/64 grid; the packed kernel at C=4 and C=64, with
1000 ``queries=`` rows at C=64, and as the capped kNN's small-input
fallback; the two kernels' rows carry their C=4 case as ``"c4"``), in
phase 2b (the parity wrapper on the card bit for bit equal
to the flat exact kernel on the card, on ``make_blocks`` batches and C=64
feature tables, and through a forced repair, a window overflow, a budget
overflow and an unsorted batch), in phases 3 (one tile served in each
mode, launch counts asserted), 5, 6 and 7.

The bf16 serving configuration (``compute_dtype="bfloat16"``: bf16 conv
operands with FP32 results, the stage kernel's tensor-core ``bf16_mm``
mode) runs in phase 2 (the bf16 stage kernel against its plain version on
every ``stage_cases`` case, within ``stage_bf16_tolerance``, the bound on
two FP32 sum orders of the same exact bf16 products; timed by
``cuda_ms_many`` beside the FP32 stage kernel and the extrema, with
cuBLAS's bf16 GEMM with an FP32 output on the bare (B*N*k, 64) x (64, 64)
product as a ceiling; its row of the kernels' line carries its status,
redesigned, and its launch geometry), phase 3 (one tile served: two bf16 stage launches per forward,
no FP32 stage launch), phase 5, phase 6 (against the CPU plain bf16
forward, probabilities within 1e-3; its argmax agreement with the FP32
forward and both times) and phase 8 (``--eval 1 --compute_dtype
bfloat16`` through ``dgcnn_tpu_torch.__main__`` on phase 7's checkpoint,
its mIoU beside FP32's). After the kernels' JSON line, one line names the
route of the trunk's bf16 products (``ops/matmul.py::bf16_route``) and
the script's run time.

Phase 2 holds the capped kNN kernel against its plain version at the
self-kNN (C=4 and C=64) and at the recall guard's probes (64 and 256 rows
of ``probe_rows`` against the C=64 table), bit for bit on integer inputs,
and times it by ``cuda_ms_many``; its row carries the C=4 self-kNN as
``"c4"`` and the probes as ``"probes_m64"`` / ``"probes_m256"``, each with
its bound (``capped_bound``).
Phase 2 holds the banded kNN kernel bit for bit against its plain version
(indices and k-th keys) on integer inputs at more geometries
(``BANDED_GEOMETRIES``: ragged N, B=1 and 8, query tiles 32-512, 16-192
windows, cap 4/6/8, every kernel width, both of its kernels) and checks
that with a False predicate it leaves its outputs as they were; its C=4
case is timed by ``cuda_ms_many`` and carried in its row as ``"c4"``.
Phase 2 holds the fused stage and extrema kernels within 1e-5 of their
plain versions on ``stage_cases``: the production shape with ``knn_capped``
indices (spread over the cloud) and with forward-like ones (the banded kNN
of ``make_blocks`` points at band 2048 and of C=64 features at band 4096),
the default forward's own stage-3 indices (:func:`forward_capture`), and
ragged shapes (B=1, N=1001, k = 20, 30, 40, indices outside [0, N));
both kernels are timed by ``cuda_ms_many`` at the production shape; the
extrema's row also carries the stage-3 case and a second bound, its
gathered rows at the card's L2 read rate for such a gather, measured in
the same run by a diagnostic build (:data:`DIAG_EXTREMA_L2`). Each
row of the kernels' JSON line carries its bound's share of its time
(``bound_share``). Phase 2 also holds the two scatter kernels of the
training backward against their plain versions, with kNN indices of
``make_blocks`` batches and uniform random ones; the training forward's
row gather (``kernels/gather_rows.py``) bit for bit; and the split packed kNN
(``knn_packed(..., splits=s)``) bit for bit on integer inputs, after which
that entry point is driven on its own with the launch counters reset, and
its routing to the flat kernel asserted. Every kernel's row in the JSON
line carries its bound: the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its FP32 operations over 67
TFLOP/s (the H100 SXM's published peaks at 700 W). The two row kernels
(``scatter_add_rows``, ``gather_rows``) and their library calls
(``index_add_``, ``torch.gather``) are timed by ``cuda_ms_many``: 50
calls per pair of events, queued behind a device sleep so that the host
does not set the pace, median of 10 runs; their rows also carry the C=4
case (``"c4"``).

Prints the kernels' JSON line and the card's ``nvidia-smi`` name and power
limit before the last line, which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without a CUDA device it fails. Scratch files go to a temporary directory
that is removed at the end.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

B, N, K = 8, 7000, 30
BANDS = dict(n_win=64, cap=6)  # the default configuration's band windows
PROBES = (64, 256)  # the recall guard's probe rows: stage A, stage B
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peaks (700 W)
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense, on the tensor cores


def bound(nbytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S
          ) -> tuple[float, str]:
    """(least milliseconds the card could take, what bounds it): FP32
    operations unless ``flop_per_s`` says otherwise."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def log(*a):
    print(*a, flush=True)


def band_pairs(band: int, qt: int, n: int = N) -> int:
    """(query, band row below N) pairs of one cloud's banded kNN: each query
    scores its tile's band rows, and a padding row needs no dot."""
    from dgcnn_tpu_torch.kernels.knn_banded import band_starts

    n_pad = -(-n // 128) * 128
    return sum(min(qt, n - i * qt) * (min(s + band, n) - s)
               for i, s in enumerate(band_starts(-(-n // qt) * qt, qt, n_pad, band)))


def banded_bound(c: int, band: int, qt: int) -> tuple[float, str]:
    """Bound of the banded kNN over a (B, N, c) batch: the rows and norms
    read, the indices and k-th keys written, once each; one FMA (2
    operations) per channel of each pair :func:`band_pairs` counts."""
    return bound(4.0 * B * N * (c + 1 + K + 1), 2.0 * B * band_pairs(band, qt) * c)


def capped_bound(c: int, m: int | None = None) -> tuple[float, str]:
    """Bound of the capped kNN of ``m`` queries (None: the self-kNN) over a
    (B, N, c) batch: the rows, their norms and the queries read once, the
    indices written once; one FMA (2 operations) per channel of each
    (query, row below N) pair."""
    q_read = 0 if m is None else m * (c + 1)
    m = N if m is None else m
    return bound(4.0 * B * (N * (c + 1) + q_read + m * K), 2.0 * B * m * N * c)


def cuda_ms(fn, reps: int) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` timed calls
    (CUDA events around each call, after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cuda_ms_many(fn, launches: int = 50, runs: int = 10) -> float:
    """Median device milliseconds per call of ``fn()``: ``runs`` timed runs
    of ``launches`` back-to-back calls between one pair of CUDA events,
    divided by the count, after one warm-up run. For kernels of tens of
    microseconds one pair of events per launch would time the launch gaps
    too, and a wrapper's host code can take longer than its kernel: so each
    run's calls are queued behind a device sleep (``torch.cuda._sleep``)
    that outlasts their enqueueing, and the card runs them back to back
    (a run whose enqueueing outlasted the sleep is repeated with a sleep
    twice as long)."""
    import torch

    for _ in range(launches):
        fn()
    torch.cuda.synchronize()
    cycles, times = 1 << 20, []
    while len(times) < runs:
        queued, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        queued.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms >= queued.elapsed_time(start):
            cycles *= 2  # the card caught up with the host: queue behind a longer sleep
            if cycles > 1 << 32:  # seconds: fn() must wait for the card
                raise RuntimeError("cuda_ms_many: the calls do not queue (a host sync?)")
            continue
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def time_scatter_rows(dy, flat_idx, n: int) -> dict:
    """``scatter_add_rows`` (the wrapper: ``torch.zeros`` of the output, then
    the kernel), its plain version and the library call, ``index_add_``
    into a freshly zeroed (B * n, C) table, all timed by
    :func:`cuda_ms_many`; with the bound (dy and the indices read once,
    the (B, n, C) output written once; one add per element)."""
    import torch

    from dgcnn_tpu_torch.kernels.scatter_rows import scatter_add_rows, scatter_add_rows_plain

    b, m, c = dy.shape
    targets = (flat_idx.long() + torch.arange(b, device=dy.device)[:, None] * n).reshape(-1)
    dy2 = dy.reshape(-1, c)
    b_ms, b_by = bound(4.0 * (b * m * c + b * m + b * n * c), b * m * c)
    return {
        "ms": cuda_ms_many(lambda: scatter_add_rows(dy, flat_idx, n)),
        "plain_ms": cuda_ms_many(lambda: scatter_add_rows_plain(dy, flat_idx, n), 10, 5),
        "library_ms": cuda_ms_many(lambda: torch.zeros(
            (b * n, c), device=dy.device).index_add_(0, targets, dy2)),
        "bound_ms": b_ms, "bound_by": b_by}


def time_gather_rows(table, idx) -> dict:
    """``gather_rows``, its plain version and the library call,
    ``torch.gather`` on the same rows (int64 indices made beforehand), all
    timed by :func:`cuda_ms_many`; with the bound (the table, the indices
    and the (B, M, C) output, once each)."""
    import torch

    from dgcnn_tpu_torch.kernels.gather_rows import gather_rows, gather_rows_plain

    b, n, c = table.shape
    m = idx.shape[1]
    lib_idx = idx.long()[..., None].expand(-1, -1, c)
    b_ms, b_by = bound(4.0 * (b * n * c + b * m + b * m * c), 0.0)
    return {
        "ms": cuda_ms_many(lambda: gather_rows(table, idx)),
        "plain_ms": cuda_ms_many(lambda: gather_rows_plain(table, idx), 10, 5),
        "library_ms": cuda_ms_many(lambda: torch.gather(table, 1, lib_idx)),
        "bound_ms": b_ms, "bound_by": b_by}


def make_blocks(b: int, n: int, seed: int) -> np.ndarray:
    """bench.py::make_blocks: x-sorted 30 m blocks, xyz + one feature."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 30.0, (b, n, 3)).astype(np.float32)
    x = np.stack([xi[np.argsort(xi[:, 0], kind="stable")] for xi in x])
    x[..., 2] = rng.uniform(0.0, 5.0, (b, n))
    feat = rng.uniform(0.0, 5.0, (b, n, 1)).astype(np.float32)
    return np.concatenate([x, feat], axis=-1)


def int_cloud(b: int, n: int, seed: int) -> np.ndarray:
    """x-sorted integer-valued points (every dot exact in FP32): x spans
    300 units, y 30, z and the feature 5."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, hi, (b, n)) for hi in (300, 30, 5, 5)],
                 axis=-1).astype(np.float32)
    order = np.argsort(x[..., 0], axis=1, kind="stable")
    return np.ascontiguousarray(np.take_along_axis(x, order[..., None], axis=1))


def forward_capture(dev) -> dict:
    """One default forward at full width (emb 1024, weights from seed 1,
    ``make_blocks(B, N, seed=0)``, a guarded dispatch) on the card, with
    what its kernels were handed recorded: the stage-1 repair's exact kNN
    call (``x``, its queries and their rows, as ``repair_queries`` picks
    them, and the failing queries per cloud) and the three stages'
    neighbour indices."""
    import torch

    from dgcnn_tpu_torch.kernels import knn_banded as kb
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn

    rec = {"idx": []}
    real_repair, real_knn = kb.repair_queries, DGCNN._knn

    def repair(x, k, idx, fail, r_budget, pred):
        # repair_queries' rows: lax.top_k's order over the fail flags
        f = fail.to(torch.int64)
        rank = torch.where(fail, f.cumsum(1) - 1,
                           f.sum(1, keepdim=True) + (1 - f).cumsum(1) - 1)
        order = torch.empty_like(rank).scatter_(
            1, rank, torch.arange(x.shape[1], device=x.device).expand(*fail.shape))
        pos = order[:, :r_budget].contiguous()
        rec["repair"] = (x, x.gather(1, pos[..., None].expand(-1, -1, x.shape[-1])), pos)
        rec["fails"] = fail.sum(1).tolist()
        return real_repair(x, k, idx, fail, r_budget, pred)

    def knn(self, *a, **kw):
        out = real_knn(self, *a, **kw)
        rec["idx"].append(out[0] if isinstance(out, tuple) else out)
        return out

    cfg = DGCNNConfig(k=K, emb_dims=1024)
    model = DGCNN(cfg)
    model.load_state_dict(init_dgcnn(cfg, torch.Generator().manual_seed(1)).state_dict())
    kb.repair_queries, DGCNN._knn = repair, knn
    try:
        with torch.inference_mode():
            model.to(dev)(torch.from_numpy(make_blocks(B, N, seed=0)).to(dev), band_mode=1)
    finally:
        kb.repair_queries, DGCNN._knn = real_repair, real_knn
    return rec


def train_capture(dev) -> dict:
    """One train step of the production configuration on the card (B=8,
    N=7000, k=30, emb 1024, dropout 0.5, Adam, the default bands; state from
    seed 1, ``make_blocks(B, N, seed=0)`` with labels and a 0.7 mask from
    seed 0, an unguarded dispatch), with what its backward hands
    ``scatter_stage_tail_rows`` recorded: stage 3's ``(u, w, am, idx)``."""
    import torch

    from dgcnn_tpu_torch.models.dgcnn import DGCNNConfig
    from dgcnn_tpu_torch.ops import edgeconv
    from dgcnn_tpu_torch.train.steps import init_train_state, make_train_step

    rec = {}
    real = edgeconv.scatter_stage_tail_rows

    def tail(u, w, am, idx, **kw):
        rec.update(u=u.clone(), w=w.clone(), am=am.clone(), idx=idx.clone())
        return real(u, w, am, idx, **kw)

    cfg = DGCNNConfig(k=K, emb_dims=1024)
    state = init_train_state(cfg, seed=1, device=str(dev), epochs=30)
    step = make_train_step(cfg, band_guard=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(make_blocks(B, N, seed=0)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 5, (B, N))).to(dev)
    mask = torch.from_numpy((rng.random((B, N)) < 0.7).astype(np.float32)).to(dev)
    edgeconv.scatter_stage_tail_rows = tail
    try:
        float(step(state, x, labels, mask, 0)["loss"])
    finally:
        edgeconv.scatter_stage_tail_rows = real
    if set(rec) != {"u", "w", "am", "idx"}:
        raise AssertionError("train_capture: the train step did not reach the stage-3 tail")
    return rec


def tail_close(got, want, u, w, am, idx) -> float:
    """Hold the tail scatter's ``(sums, count)`` against the plain
    version's: the count exact; each sum within 1e-5 (absolute and
    relative) or, on a row that takes many entries (a clamped row 0 or
    N-1, a hub of a feature-space kNN), within twice the recursive-
    summation bound (hits - 1) * 2^-24 * sum |term| of each of the two
    sums, which add the same terms in different (atomic) orders. Returns
    the largest difference."""
    import torch

    from dgcnn_tpu_torch.kernels.scatter_rows import scatter_stage_tail_rows_plain

    torch.cuda.synchronize()
    if not torch.equal(got[1], want[1]):
        raise AssertionError("scatter_stage_tail_rows: the count differs from the plain version's")
    mag = scatter_stage_tail_rows_plain(u.abs(), w.abs(), am, idx)[0]
    err = (got[0] - want[0]).abs()
    ok = torch.maximum(1e-5 + 1e-5 * want[0].abs(), 2 * want[1][..., None] * 2.0 ** -24 * mag)
    if not (err <= ok).all():
        raise AssertionError(f"scatter_stage_tail_rows: sums differ by up to "
                             f"{err.max().item():.3e}")
    return err.max().item()


def tail_bound(b: int, n: int, k: int, c: int) -> tuple[float, str]:
    """Bound of the stage-3 tail scatter: u and w (FP32), am (int8) and the
    indices read once, the sums and the count written once; one add per
    (entry, channel) and one select, 2 operations."""
    return bound(4.0 * (2 * b * n * c + b * n * k + b * n * c + b * n) + b * n * c,
                 2.0 * b * n * k * c)


# A diagnostic build of the row scatter kernel (scripts/kernel_variants.py)
# whose rows cycle over the first 256 rows of a small dy (L1 / L2
# resident), so that its time is the reductions': into the L2-resident
# (B, N, 64) output at the given indices, by float4 vector reductions or
# (the output one float off 16-byte alignment) scalar ones, neighbouring
# lanes on neighbouring channels.
DIAG_REDUCTION_RATE = [
    ("    const T* db = dy + (size_t)b * M * g;", "    const T* db = dy;"),
    ("        v[r] = __ldcs(db + s);", "        v[r] = __ldg(db + s % (256 * g));")]


def start_reduction_diag(out_dir):
    """Start building :data:`DIAG_REDUCTION_RATE` (in the background);
    :func:`global_reduction_rate` finishes it."""
    from pathlib import Path

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import kernel_variants as kv

    return kv.start_build("diag_reduction_rate", DIAG_REDUCTION_RATE, Path(out_dir),
                          ("scatter_rows.cu",), ("scatter_rows.cu",))


def global_reduction_rate(started, idx, c: int = 64) -> dict:
    """The card's global reduction rate on the (B, N, k) indices ``idx``
    (the train step's stage 3): B*N*k rows of ``c`` FP32 adds into an
    L2-resident (B, N, c) output, by float4 vector reductions and by
    scalar ones, from the diagnostic build (:func:`start_reduction_diag`),
    50 launches per event pair (:func:`cuda_ms_many`). Reductions per
    second count one per float4 or per float; bytes per second the FP32
    payload added."""
    import ctypes

    import torch

    import kernel_variants as kv

    lib, _ = kv.finish_build("diag_reduction_rate", *started)
    b, n, k = idx.shape
    flat = idx.reshape(b, n * k).contiguous()
    dy = torch.randn((256, c), device=idx.device)
    res = {}
    for label, shift in (("float4", 0), ("scalar", 1)):
        buf = torch.zeros(b * n * c + shift, device=idx.device)
        out = buf[shift:]

        def run():
            err = lib.dgcnn_scatter_add_rows(
                dy.data_ptr(), flat.data_ptr(), out.data_ptr(), None, b, n * k, n, c,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"diag_reduction_rate ({label}): CUDA error {err}")

        ms = cuda_ms_many(run)
        reds = b * n * k * (c // 4 if label == "float4" else c)
        res[label] = {"ms": ms, "reductions_per_s": reds / ms * 1e3,
                      "bytes_per_s": 4.0 * b * n * k * c / ms * 1e3}
    return res


# A diagnostic build of the extrema kernel (scripts/kernel_variants.py)
# that reads every (query, neighbour) row from L2 (ld.global.cg, past L1),
# its warps striding over all queries (no range an SM shares in L1). On
# row-local indices it times the card's L2 read rate for this gather, row
# 3's second bound.
DIAG_EXTREMA_L2 = [
    ("const float2 g = __ldg(reinterpret_cast<const float2*>(tab + (size_t)nb * kC + c));",
     "const float2 g = __ldcg(reinterpret_cast<const float2*>(tab + (size_t)nb * kC + c));"),
    ("  for (long long row = lo + warp; row < hi; row += kXWarps) {",
     "  for (long long row = (long long)blockIdx.x * kXWarps + warp; row < total;\n"
     "       row += (long long)gridDim.x * kXWarps) {")]


def start_l2_diag(out_dir):
    """Start building :data:`DIAG_EXTREMA_L2` (one nvcc per source, in the
    background); :func:`l2_gather_rate` finishes it."""
    from pathlib import Path

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import kernel_variants as kv

    return kv.start_build("diag_extrema_l2", DIAG_EXTREMA_L2, Path(out_dir),
                          ("edgeconv_fused.cu",), ("edgeconv_fused.cu",))


def l2_gather_rate(started, table, k) -> dict:
    """The card's L2 read rate for the extrema's gather, from the
    diagnostic build: B*N*k rows of 256 bytes, each query's neighbours the
    rows around its own (so the table, 1.8 MB a cloud, stays in L2), 50
    launches per event pair (:func:`cuda_ms_many`). Returns the time, the
    bytes and the rate."""
    import ctypes

    import torch

    import kernel_variants as kv

    lib, _ = kv.finish_build("diag_extrema_l2", *started)
    b, n, _ = table.shape
    local = (torch.arange(n, device=table.device)[:, None]
             + torch.arange(k, device=table.device) - k // 2).clamp(0, n - 1)
    idx = local.to(torch.int32).expand(b, n, k).contiguous()
    ones = torch.ones(64, device=table.device)
    out = torch.empty_like(table)

    def run():
        err = lib.dgcnn_edgeconv_extrema(
            table.data_ptr(), idx.data_ptr(), table.data_ptr(), ones.data_ptr(),
            ones.data_ptr(), ones.data_ptr(), out.data_ptr(), b, n, k, 0,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"diag_extrema_l2: CUDA error {err}")

    ms = cuda_ms_many(run)
    nbytes = 256.0 * b * n * k
    return {"ms": ms, "bytes": nbytes, "bytes_per_s": nbytes / ms * 1e3}


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke test needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    from dgcnn_tpu_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: {nvcc}")
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s -> {path}")
    log(path.with_suffix(".log").read_text() if path.with_suffix(".log").exists() else "")
    return smi


def _compare(name, x, q, got, want, int_valued):
    """Hold a kernel's (B, M, k) neighbours of queries ``q`` among ``x``
    against the plain version's: bit-equal on integer inputs; on floats,
    agreement >= 0.999 and equal distances up to the packed keys'
    resolution. Returns (agreement, max |d2 diff|)."""
    import torch

    agree = (got == want).float().mean().item()

    def d2(idx):  # squared distances of the selected neighbours, rank by rank
        b, m, k = idx.shape
        nb = torch.gather(x, 1, idx.long().reshape(b, -1, 1).expand(-1, -1, x.shape[-1]))
        return ((nb.reshape(b, m, k, -1) - q[:, :, None, :]) ** 2).sum(-1)

    want_d2 = d2(want)
    derr = (d2(got) - want_d2).abs()
    if int_valued:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain on integer inputs "
                                 f"(agreement {agree})")
    else:
        # packed keys keep ~18 bits of the score: where the two FP32 sum
        # orders quantize a near-tie differently, the swapped neighbours'
        # distances agree to the key resolution (2^-8 relative)
        rel = (derr / want_d2.abs().clamp_min(1e-6)).max().item()
        if agree < 0.999 or rel > 2.0 ** -8:
            raise AssertionError(f"{name}: agreement {agree}, distance rel err {rel}")
    return agree, derr.max().item()


def _case(name, x, q, int_valued, run, plain, results, reps=20, plain_reps=3,
          extra=None, queued=False):
    """One kernel check: run both, compare (plus ``extra(got, want)``),
    time both, record. ``queued``: time the kernel by :func:`cuda_ms_many`
    (kernels of tens of microseconds), else both by :func:`cuda_ms`."""
    import torch

    got = run()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    if extra is not None:
        extra(got, want)
    if isinstance(got, tuple):
        got, want = got[0], want[0]
    agree, err = _compare(name, x, q, got, want, int_valued)
    if queued:  # the plain version (tens of ms) by one event pair per call
        ms, plain_ms = cuda_ms_many(run), cuda_ms(plain, plain_reps)
    else:
        ms, plain_ms = cuda_ms(run, reps), cuda_ms(plain, plain_reps)
    log(f"{name}: agreement {agree:.6f}, max |d2 diff| {err:.3e}, "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    results.append({"case": name, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})


def grid_cloud(b: int, n: int, c: int, seed: int) -> np.ndarray:
    """x-sorted points on a 1/64 grid (tests/test_knn_exact.py): every dot
    term and partial sum is exact in FP32, so any summation order gives
    the same scores, bit for bit."""
    rng = np.random.default_rng(seed)
    spans = np.array([30.0] + [4.0] * (c - 1))
    x = (np.round(rng.uniform(0.0, 1.0, (b, n, c)) * spans * 64.0) / 64.0).astype(np.float32)
    order = np.argsort(x[..., 0], axis=1, kind="stable")
    return np.ascontiguousarray(np.take_along_axis(x, order[..., None], axis=1))


# the banded kernel's geometries beyond the two production ones: (c, b, n,
# band, n_win, cap, query tile) — ragged N, one and eight clouds, query
# tiles of 32-512 rows (32- and 64-query blocks), 16-192 windows (one and
# several rounds of 64), cap 4/6/8, every kernel width (the fused kernel
# at C <= 8, the two-phase one above), windows shorter than cap, and the
# smallest launch geometry (shared memory near the limit)
BANDED_GEOMETRIES = (
    (3, 2, 4500, 512, 16, 8, 128), (4, 1, 7000, 2048, 64, 6, 512),
    (8, 1, 4500, 1024, 32, 4, 32), (16, 1, 7000, 2048, 16, 8, 128),
    (32, 8, 4500, 1024, 64, 4, 384), (64, 2, 4500, 4096, 32, 8, 512),
    (5, 1, 4500, 256, 64, 6, 128), (4, 1, 4500, 1536, 128, 4, 256),
    (64, 1, 4500, 384, 192, 8, 384), (64, 8, 4500, 4096, 64, 6, 384),
    (4, 8, 4500, 2048, 64, 6, 512), (32, 1, 4500, 1024, 64, 6, 160),
    (64, 1, 4500, 1536, 96, 4, 384),
)


def banded_geometries(rng) -> None:
    """The banded kernel bit for bit against its plain version (indices and
    k-th keys) on integer inputs at :data:`BANDED_GEOMETRIES`; and with a
    False predicate it leaves its outputs as they were: two launches on
    the same prepared inputs, the first one's outputs filled with -7 and
    freed (after ``empty_cache``, so the allocator hands the same blocks to
    the second)."""
    import torch

    from dgcnn_tpu_torch.kernels.knn_banded import (
        knn_banded_raw, knn_banded_raw_plain, launch_geometry, launch_kernel)

    dev = torch.device("cuda")
    for c, b, n, band, n_win, cap, qt in BANDED_GEOMETRIES:
        x = torch.from_numpy(rng.integers(0, 16, (b, n, c)).astype(np.float32)).to(dev)
        kw = dict(band=band, n_win=n_win, cap=cap, query_tile=qt)
        got, want = knn_banded_raw(x, K, **kw), knn_banded_raw_plain(x, K, **kw)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"knn_banded C={c} B={b} N={n} {kw}: kernel != plain")
    x = torch.from_numpy(rng.integers(0, 16, (B, N, 4)).astype(np.float32)).to(dev)
    cn = (x * x).sum(-1)
    kw = dict(band=2048, query_tile=512, **BANDS)
    g = launch_geometry(4, 2048, BANDS["n_win"], BANDS["cap"], 512)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    idx0, kth0 = launch_kernel(x, cn, K, geometry=g, pred=no, **kw)
    idx0.fill_(-7)
    kth0.fill_(-7)
    ptrs = (idx0.data_ptr(), kth0.data_ptr())
    del idx0, kth0
    idx1, kth1 = launch_kernel(x, cn, K, geometry=g, pred=no, **kw)
    torch.cuda.synchronize()
    if (idx1.data_ptr(), kth1.data_ptr()) != ptrs:
        raise AssertionError("knn_banded pred=0 check: the allocator moved the outputs")
    if not ((idx1 == -7).all() and (kth1 == -7).all()):
        raise AssertionError("knn_banded: a False predicate wrote the outputs")
    log(f"knn_banded: {len(BANDED_GEOMETRIES)} more geometries bit-equal to the plain "
        "version on integers; pred=0 leaves the outputs")


def phase_kernels():
    import torch

    from dgcnn_tpu_torch.kernels.knn_banded import (
        knn_banded_raw, knn_banded_raw_plain, probe_rows)
    from dgcnn_tpu_torch.kernels.knn_capped import knn_capped, knn_capped_plain
    from dgcnn_tpu_torch.kernels.knn_exact import knn_exact, knn_exact_plain
    from dgcnn_tpu_torch.kernels.knn_exact_banded import (
        knn_exact_banded_raw, knn_exact_banded_raw_plain)
    from dgcnn_tpu_torch.kernels.knn_packed import knn_packed, knn_packed_plain

    dev = torch.device("cuda")
    red_diag = start_reduction_diag(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                 "build", "chip_smoke"))
    rng = np.random.default_rng(0)
    res = {"knn_capped": [], "knn_banded": [], "knn_exact": [], "knn_exact_banded": [],
           "knn_packed": []}
    pts = torch.from_numpy(make_blocks(B, N, seed=0)).to(dev)
    feats = torch.from_numpy(rng.standard_normal((B, N, 64), np.float32)).to(dev)
    ints = {c: torch.from_numpy(rng.integers(0, 16, (B, N, c)).astype(np.float32)).to(dev)
            for c in (4, 64)}

    for name, x, int_valued in (("int C=4", ints[4], True), ("int C=64", ints[64], True),
                                ("float C=4 (blocks)", pts, False),
                                ("float C=64", feats, False)):
        _case(f"knn_capped {name}", x, x, int_valued, lambda x=x: knn_capped(x, K),
              lambda x=x: knn_capped_plain(x, K), res["knn_capped"], queued=True)
    # the recall guard's probes: 64 (stage A) and 256 (stage B) rows of
    # probe_rows against the whole C=64 table, on integers and on floats
    for m in PROBES:
        rows = probe_rows(N, m, dev)
        for name, x, int_valued in (("int", ints[64], True), ("float", feats, False)):
            q = x[:, rows].contiguous()
            _case(f"knn_capped {name} C=64 probes M={m}", x, q, int_valued,
                  lambda x=x, q=q: knn_capped(x, K, queries=q),
                  lambda x=x, q=q: knn_capped_plain(x, K, queries=q), res["knn_capped"],
                  queued=True)

    def equal_keys(got, want):
        if not torch.equal(got[1], want[1]):
            raise AssertionError("knn_banded: k-th keys differ on integer inputs")

    for c, band, qt, xf in ((4, 2048, 512, pts), (64, 4096, 384, feats)):
        kw = dict(band=band, query_tile=qt, **BANDS)
        for name, x, int_valued in ((f"int C={c} band {band}", ints[c], True),
                                    (f"float C={c} band {band}", xf, False)):
            _case(f"knn_banded {name}", x, x, int_valued,
                  lambda x=x, kw=kw: knn_banded_raw(x, K, **kw),
                  lambda x=x, kw=kw: knn_banded_raw_plain(x, K, **kw),
                  res["knn_banded"], extra=equal_keys if int_valued else None,
                  queued=c == 4)
    banded_geometries(rng)

    q = ints[4][:, torch.randperm(N, device=dev)[:256]]  # random rows, as many as the repair's
    _case("knn_exact int C=4, 256 queries", ints[4], q, True,
          lambda: knn_exact(ints[4], K, queries=q),
          lambda: knn_exact_plain(ints[4], K, queries=q), res["knn_exact"], queued=True)
    # the repair's own call in the default forward: the 256 rows per cloud
    # repair_queries picks on make_blocks (the failing rows first), with
    # their rows as the kernel's hint, which must change no index
    fwd = forward_capture(dev)
    xr, qr, rows = fwd["repair"]

    def hint_free(got, want):
        if not torch.equal(got, knn_exact(xr, K, queries=qr)):
            raise AssertionError("knn_exact: the row hint changed the indices")

    _case("knn_exact repair (make_blocks, the forward's 256 queries)", xr, qr, False,
          lambda: knn_exact(xr, K, queries=qr, query_rows=rows),
          lambda: knn_exact_plain(xr, K, queries=qr), res["knn_exact"], queued=True,
          extra=hint_free)
    res["knn_exact"][-1]["failing_queries_per_cloud"] = fwd["fails"]
    log(f"knn_exact repair: failing queries per cloud {fwd['fails']}")
    big = torch.from_numpy(rng.integers(0, 64, (1, 40000, 4)).astype(np.float32)).to(dev)
    _case("knn_exact int C=4, self N=40000 (capped past 15 index bits)", big, big, True,
          lambda: knn_capped(big, K), lambda: knn_exact_plain(big, K), res["knn_exact"],
          reps=5, plain_reps=2)

    # the parity mode's kernel: stage 1 (C=4, band 2048) and stages 2-3
    # (C=64, full width: band = n_pad = 7040), 64 windows, cap 8, the
    # wrapper's 256-row query tile; on the grid all three outputs bit-equal
    def equal_kth_ovf(got, want):
        if not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
            raise AssertionError("knn_exact_banded: k-th keys or overflow flags differ on the grid")

    def equal_flat_where_certified(x):
        # at full width a row whose windows did not overflow holds the exact
        # top-k, and both kernels score with csrc/knn_common.cuh: there the
        # indices are the flat exact kernel's bit for bit, on floats too
        def check(got, want):
            idx, _, ovf = got
            ok = ovf == 0
            flat = knn_exact(x, K)
            if not ok.any() or not torch.equal(idx[ok], flat[ok]):
                raise AssertionError("knn_exact_banded: full-width rows without overflow "
                                     "differ from the flat exact kernel")
            log(f"knn_exact_banded full width: {int(ok.sum())} of {ok.numel()} rows "
                "without overflow, bit-equal to the flat exact kernel")
        return check

    n_pad = -(-N // 128) * 128
    for c, band, xf in ((4, 2048, pts), (64, n_pad, feats)):
        kw = dict(band=band, n_win=64, cap=8, query_tile=256)
        grid = torch.from_numpy(grid_cloud(B, N, c, seed=c)).to(dev)
        for name, x, on_grid in ((f"grid C={c} band {band}", grid, True),
                                 (f"float C={c} band {band}", xf, False)):
            checks = [equal_kth_ovf] if on_grid else []
            if band == n_pad:
                checks.append(equal_flat_where_certified(x))

            def extra(got, want, checks=checks):
                for check in checks:
                    check(got, want)

            _case(f"knn_exact_banded {name}", x, x, on_grid,
                  lambda x=x, kw=kw: knn_exact_banded_raw(x, K, **kw),
                  lambda x=x, kw=kw: knn_exact_banded_raw_plain(x, K, **kw),
                  res["knn_exact_banded"], plain_reps=2, extra=extra, queued=True)

    # the packed mode's kernel (self-kNN, and 1000 ``queries=`` rows of the
    # C=64 tables), and the capped kNN's small-input fallback
    rows = torch.from_numpy(np.random.default_rng(17).permutation(N)[:1000]).to(dev)
    for name, x, q, int_valued in (
            ("int C=4", ints[4], None, True), ("int C=64", ints[64], None, True),
            ("float C=4 (blocks)", pts, None, False), ("float C=64", feats, None, False),
            ("int C=64 1000 queries", ints[64], ints[64][:, rows].contiguous(), True),
            ("float C=64 1000 queries", feats, feats[:, rows].contiguous(), False)):
        _case(f"knn_packed {name}", x, x if q is None else q, int_valued,
              lambda x=x, q=q: knn_packed(x, K, queries=q),
              lambda x=x, q=q: knn_packed_plain(x, K, queries=q), res["knn_packed"],
              plain_reps=2, queued=True)
    small = ints[4][:, :200]  # 1 window of 256 rows: n_win * cap = 8 < k
    before = knn_packed.launches
    _case("knn_packed int C=4 N=200 via knn_capped (n_win*cap < k)", small, small, True,
          lambda: knn_capped(small, K), lambda: knn_packed_plain(small, K), res["knn_packed"])
    if knn_packed.launches == before:
        raise AssertionError("knn_capped's small-input fallback did not launch knn_packed")

    return (res, phase_fused(dev), phase_scatter(pts, red_diag), phase_gather(pts),
            phase_split(pts))


def stage_cases(dev) -> dict:
    """The fused stage kernels' inputs, from one seed: seeded normal
    ``table`` and ``bvec`` (B, N, 64), W2 uniform in +-1/8, three folded
    BNs with scales of both signs; indices of the production shape (B=8,
    N=7000, k=30) from ``knn_capped`` on seeded C=64 normals (spread over
    the whole cloud), and forward-like ones, local in x-sorted order: the
    banded kNN of ``make_blocks`` points at band 2048 (stage 1) and of the
    C=64 normals at band 4096 (stage 2), and the default forward's own
    stage-3 indices (:func:`forward_capture`); then ragged cases, B=1, N=1001,
    k = 20, 30, 40, with uniform indices of which a few lie outside
    [0, N) (clamped). Each case: a dict of the wrappers' arguments."""
    import torch

    from dgcnn_tpu_torch.kernels.edgeconv_fused import fold_bn
    from dgcnn_tpu_torch.kernels.knn_banded import knn_banded_raw
    from dgcnn_tpu_torch.kernels.knn_capped import knn_capped

    rng = np.random.default_rng(5)

    def on(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def bn():
        g = rng.uniform(0.5, 1.5, 64) * rng.choice([-1.0, 1.0], 64)
        return fold_bn(*(on(v) for v in (g, rng.normal(0, 0.2, 64), rng.normal(0, 0.3, 64),
                                          rng.uniform(0.5, 2.0, 64)))), on(g)

    def operands(b, n):
        table, bvec = (on(rng.standard_normal((b, n, 64))) for _ in range(2))
        w2 = on(rng.uniform(-0.125, 0.125, (64, 64)))
        (sa, ta), _ = bn()
        (sb, tb), _ = bn()
        (s5, t5), gamma = bn()
        return dict(table=table, bvec=bvec, w2=w2, sa=sa, ta=ta, sb=sb, tb=tb, gamma=gamma,
                    s5=s5, t5=t5)

    feats = on(rng.standard_normal((B, N, 64)))
    pts = torch.from_numpy(make_blocks(B, N, seed=0)).to(dev)
    prod = operands(B, N)
    cases = {
        "capped C=64": {**prod, "idx": knn_capped(feats, K)},
        "banded stage 1 (blocks, band 2048)": {**prod, "idx": knn_banded_raw(
            pts, K, band=2048, query_tile=512, **BANDS)[0]},
        "banded stage 2 (C=64, band 4096)": {**prod, "idx": knn_banded_raw(
            feats, K, band=4096, query_tile=384, **BANDS)[0]},
        "stage 3 (the default forward's indices)": {**prod,
                                                    "idx": forward_capture(dev)["idx"][2]},
    }
    for k in (20, 30, 40):
        idx = rng.integers(-3, 1001 + 3, (1, 1001, k)).astype(np.int32)
        cases[f"ragged B=1 N=1001 k={k}"] = {
            **operands(1, 1001), "idx": torch.from_numpy(idx).to(dev)}
    return cases


def stage_args(case: dict) -> tuple:
    """``edgeconv_fused_stage``'s positional arguments of a :func:`stage_cases` case."""
    return tuple(case[key] for key in ("table", "idx", "bvec", "w2", "sa", "ta", "sb", "tb"))


def extrema_args(case: dict) -> tuple:
    """``edgeconv_fused_extrema``'s positional arguments of a case."""
    return tuple(case[key] for key in ("table", "idx", "bvec", "gamma", "s5", "t5"))


def phase_fused(dev) -> list:
    """The fused stage and extrema kernels against their plain versions on
    every :func:`stage_cases` case (max abs diff at most 1e-5: the 64-long
    dot is summed in another order than cuBLAS's; the extrema kernel sums
    nothing); each kernel timed by :func:`cuda_ms_many` on the production
    cases, the plain versions by :func:`cuda_ms` on the first. Returns the
    two kernels' records, the first case's times at the top level."""
    import torch

    from dgcnn_tpu_torch.kernels.edgeconv_fused import (
        edgeconv_fused_extrema, edgeconv_fused_extrema_plain, edgeconv_fused_stage,
        edgeconv_fused_stage_bf16, edgeconv_fused_stage_plain, launch_geometry_bf16,
        stage_bf16_tolerance)
    from dgcnn_tpu_torch.ops.matmul import bf16_route

    diag = start_l2_diag(os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                      "chip_smoke"))
    inputs = stage_cases(dev)
    records = []
    for name, fn, plain, args in (
            ("edgeconv_fused_stage", edgeconv_fused_stage, edgeconv_fused_stage_plain,
             stage_args),
            ("edgeconv_fused_extrema", edgeconv_fused_extrema, edgeconv_fused_extrema_plain,
             extrema_args)):
        cases = []
        for label, case in inputs.items():
            a = args(case)
            got = fn(*a)
            torch.cuda.synchronize()
            want = plain(*a)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not err <= 1e-5:
                raise AssertionError(f"{name} {label}: max abs diff {err} > 1e-5")
            row = {"case": label, "max_abs_err": err}
            if not label.startswith("ragged"):
                row["ms"] = cuda_ms_many(lambda a=a: fn(*a))
                if not cases:
                    row["plain_ms"] = cuda_ms(lambda a=a: plain(*a), 5)
            log(f"{name} {label}: max abs diff {err:.3e}" + "".join(
                f", {key} {row[key]:.4f}" for key in ("ms", "plain_ms") if key in row))
            cases.append(row)
        records.append({"name": name, "max_abs_err": max(r["max_abs_err"] for r in cases),
                        "ms": cases[0]["ms"], "plain_ms": cases[0]["plain_ms"],
                        "cases": cases})
    # the extrema's second bound: its B*N*k gathered rows at the card's L2
    # read rate for such a gather
    l2 = l2_gather_rate(diag, inputs["capped C=64"]["table"], K)
    log(f"L2 gather ceiling: {l2['bytes'] / 1e6:.1f} MB in {l2['ms']:.4f} ms, "
        f"{l2['bytes_per_s'] / 1e12:.3f} TB/s")
    records[1]["l2_gather"] = l2

    # the bf16 stage kernel (the stage's bf16_mm mode) against its plain
    # version on every case, within stage_bf16_tolerance: both sum a row's
    # 64 exact bf16 products in FP32, in other orders (the tensor cores a
    # k-step at once); timed beside the FP32 kernel's time above
    cases = []
    for label, case in inputs.items():
        a = stage_args(case)
        got = edgeconv_fused_stage_bf16(*a)
        torch.cuda.synchronize()
        want = edgeconv_fused_stage_plain(*a, bf16_mm=True)
        tol = stage_bf16_tolerance(*a[:7])
        torch.cuda.synchronize()
        err = (got - want).abs()
        row = {"case": label, "max_abs_err": err.max().item(),
               "tolerance_share": (err / tol.clamp_min(1e-30)).max().item()}
        if not (err <= tol).all():
            raise AssertionError(f"edgeconv_fused_stage_bf16 {label}: beyond the tolerance "
                                 f"({row})")
        del tol, err, want
        if not label.startswith("ragged"):
            row["ms"] = cuda_ms_many(lambda a=a: edgeconv_fused_stage_bf16(*a))
            if not cases:
                row["plain_ms"] = cuda_ms(
                    lambda a=a: edgeconv_fused_stage_plain(*a, bf16_mm=True), 5)
        log(f"edgeconv_fused_stage_bf16 {label}: max abs diff {row['max_abs_err']:.3e} "
            f"({row['tolerance_share']:.3f} of the tolerance)" + "".join(
                f", {key} {row[key]:.4f}" for key in ("ms", "plain_ms") if key in row))
        cases.append(row)
    # ceilings, not yardsticks (no gather, no max): cuBLAS for the bare
    # (B*N*k, 64) x (64, 64) product, bf16 with an FP32 output where this
    # torch has that call, and FP32
    x = torch.randn(B * N * K, 64, device=dev)
    w2 = inputs["capped C=64"]["w2"]
    xb, wb = x.to(torch.bfloat16), w2.to(torch.bfloat16)
    ceil = {"cublas_f32_ms": cuda_ms_many(lambda: torch.mm(x, w2)), "cublas_bf16_ms": None}
    if bf16_route(dev) == "mm_out_dtype":
        ceil["cublas_bf16_ms"] = cuda_ms_many(
            lambda: torch.mm(xb, wb, out_dtype=torch.float32))
    del x, xb
    log(f"bare (B*N*k, 64) x (64, 64) product: cuBLAS FP32 {ceil['cublas_f32_ms']:.4f} ms, "
        f"bf16 with an FP32 output {ceil['cublas_bf16_ms']} ms")
    # its launch: warps a block and a contiguous range of queries a block
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    records.append({"name": "edgeconv_fused_stage_bf16",
                    "max_abs_err": max(r["max_abs_err"] for r in cases),
                    "ms": cases[0]["ms"], "plain_ms": cases[0]["plain_ms"],
                    "f32_ms": records[0]["ms"], **ceil,
                    "geometry": launch_geometry_bf16(B, N, K, sms), "cases": cases})
    return records


def phase_scatter(pts, red_diag):
    """The training backward's scatter kernels against their plain
    versions at the train step's shapes: stage 2's gather VJP (C=64,
    210 000 rows per cloud) and stage 3's tail (C=64), plus the C=4 width
    of a stage-1 gather VJP (the train step skips that one: the input
    points need no gradient), with the kNN indices of ``make_blocks``
    batches and uniform random ones; the tail also on what one seeded
    production train step hands it (:func:`train_capture`), where the
    card's global reduction rate is measured too
    (:func:`global_reduction_rate`). Then the row scatter on a ragged case
    (N=1001, M=12345, C in 1 / 3 / 4 / 8 / 64 / 68 / 128) with indices
    outside [0, N), which clamp, and the tail on ragged cases (B=1, N=1001,
    k=20, the same widths: tiles of 7 queries) and past the tile route
    (B=1, N=60 000: the global route), with a False predicate leaving
    zeros. The sums are atomic, so their order changes from run to run: 1e-5
    absolute and relative (the tail's ragged cases, whose clamped rows 0
    and N-1 take ~8x the entries: 1e-5 or, on such rows, twice the
    recursive-summation bound, :func:`tail_close`); the count exact. Times:
    kernel, plain
    version and ``index_add_`` by :func:`cuda_ms_many`, each with the
    zeroing of its output where it needs one."""
    import torch

    from dgcnn_tpu_torch.kernels.knn_capped import knn_capped
    from dgcnn_tpu_torch.kernels.scatter_rows import (
        scatter_add_rows, scatter_add_rows_plain, scatter_stage_tail_rows,
        scatter_stage_tail_rows_plain, tail_plan)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    indices = {"kNN of blocks": knn_capped(pts, K),
               "uniform": torch.randint(0, N, (B, N, K), generator=g, device=dev,
                                        dtype=torch.int32)}
    rows = {"scatter_add_rows": [], "scatter_stage_tail_rows": []}

    def tail_case(label, u, w, am, idx, reps=50):
        sums, count = scatter_stage_tail_rows(u, w, am, idx)
        want_sums, want_count = scatter_stage_tail_rows_plain(u, w, am, idx)
        torch.cuda.synchronize()
        torch.testing.assert_close(sums, want_sums, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(count, want_count, atol=0, rtol=0)
        err = (sums - want_sums).abs().max().item()
        ms = cuda_ms_many(lambda: scatter_stage_tail_rows(u, w, am, idx), reps)
        plain_ms = cuda_ms_many(lambda: scatter_stage_tail_rows_plain(u, w, am, idx), 5, 5)
        b_, n_, c_ = u.shape
        b_ms, b_by = tail_bound(b_, n_, idx.shape[-1], c_)
        qt = tail_plan(b_, n_, idx.shape[-1], c_)
        log(f"scatter_stage_tail_rows ({label}): max abs diff {err:.3e}, kernel {ms:.4f} ms "
            f"({qt} queries a tile), plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms")
        rows["scatter_stage_tail_rows"].append({
            "case": label, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "queries_a_tile": qt})

    cap = train_capture(dev)
    tail_case("C=64 stage 3 (the train step's own inputs)", cap["u"], cap["w"], cap["am"],
              cap["idx"])
    rate = global_reduction_rate(red_diag, cap["idx"])
    rows["global_reduction_rate"] = rate
    log("global reductions on the train step's stage-3 indices into a (B, N, 64) output: "
        + ", ".join(f"{k_} {v['ms']:.4f} ms, {v['reductions_per_s'] / 1e9:.1f} G/s, "
                    f"{v['bytes_per_s'] / 1e12:.2f} TB/s" for k_, v in rate.items()))
    del cap
    for label, idx in indices.items():
        flat_idx = idx.reshape(B, N * K)
        for c in (4, 64):
            dy = torch.randn((B, N * K, c), generator=g, device=dev)
            got = scatter_add_rows(dy, flat_idx, N)
            want = scatter_add_rows_plain(dy, flat_idx, N)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            err = (got - want).abs().max().item()
            t = time_scatter_rows(dy, flat_idx, N)
            log(f"scatter_add_rows C={c} ({label}): max abs diff {err:.3e}, kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, zeros + index_add_ "
                f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
            rows["scatter_add_rows"].append({"case": f"C={c} {label}", "max_abs_err": err, **t})
        u = torch.randn((B, N, 64), generator=g, device=dev)
        w = torch.randn((B, N, 64), generator=g, device=dev)
        am = torch.randint(0, K, (B, N, 64), generator=g, device=dev).to(torch.int8)
        tail_case(f"C=64 {label}", u, w, am, idx)
    n, m = 1001, 12345
    idx = torch.randint(-7, n + 7, (3, m), generator=g, device=dev, dtype=torch.int32)
    for c in (1, 3, 4, 8, 64, 68, 128):
        dy = torch.randn((3, m, c), generator=g, device=dev)
        got = scatter_add_rows(dy, idx, n)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, scatter_add_rows_plain(dy, idx, n), atol=1e-5,
                                   rtol=1e-5)
    log(f"scatter_add_rows ragged (B=3, N={n}, M={m}, C=1/3/4/8/64/68/128, indices in "
        "[-7, N+7)): within 1e-5, clamped")
    no = torch.zeros((), dtype=torch.bool, device=dev)
    for b_, n_, k_, widths in ((1, n, 20, (1, 3, 4, 64, 128)), (1, 60000, K, (64,))):
        idx = torch.randint(-7, n_ + 7, (b_, n_, k_), generator=g, device=dev,
                            dtype=torch.int32)
        for c in widths:
            u, w = (torch.randn((b_, n_, c), generator=g, device=dev) for _ in range(2))
            am = torch.randint(-1, k_, (b_, n_, c), generator=g, device=dev).to(torch.int8)
            tail_close(scatter_stage_tail_rows(u, w, am, idx),
                       scatter_stage_tail_rows_plain(u, w, am, idx), u, w, am, idx)
            if any(t.any() for t in scatter_stage_tail_rows(u, w, am, idx, pred=no)):
                raise AssertionError(f"scatter_stage_tail_rows N={n_} C={c}: a False "
                                     "predicate left non-zeros")
        log(f"scatter_stage_tail_rows ragged (B={b_}, N={n_}, k={k_}, C="
            f"{'/'.join(map(str, widths))}, indices in [-7, N+7); {tail_plan(b_, n_, k_, widths[-1])} "
            "queries a tile): within 1e-5, count exact, clamped; a False predicate: zeros")
    return rows


def phase_gather(pts):
    """The training forward's row gather against its plain version, bit
    for bit (it is a copy), at the train step's shapes: (B, N*k) indices of
    ``make_blocks`` batches and uniform random ones into C=4 (stage 1
    gathers the points) and C=64 tables (stages 2-3); then a ragged case
    (N=1001, M=12345, C in 1 / 3 / 4 / 8 / 64 / 68 / 128) with indices
    outside [0, N), which clamp.
    ``torch.gather`` on the same rows is the library call (the port never
    makes it on the card), timed like the kernel (:func:`cuda_ms_many`)."""
    import torch

    from dgcnn_tpu_torch.kernels.gather_rows import gather_rows, gather_rows_plain
    from dgcnn_tpu_torch.kernels.knn_capped import knn_capped

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    indices = {"kNN of blocks": knn_capped(pts, K).reshape(B, N * K),
               "uniform": torch.randint(0, N, (B, N * K), generator=g, device=dev,
                                        dtype=torch.int32)}
    rows = []
    for label, idx in indices.items():
        for c in (4, 64):
            table = pts if c == 4 else torch.randn((B, N, c), generator=g, device=dev)
            got = gather_rows(table, idx)
            want = gather_rows_plain(table, idx)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"gather_rows C={c} ({label}): kernel != plain")
            t = time_gather_rows(table, idx)
            log(f"gather_rows C={c} ({label}): bit-equal, kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, torch.gather {t['library_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms")
            rows.append({"case": f"C={c} {label}", "max_abs_err": 0.0, **t})
    n, m = 1001, 12345
    idx = torch.randint(-7, n + 7, (3, m), generator=g, device=dev, dtype=torch.int32)
    for c in (1, 3, 4, 8, 64, 68, 128):
        table = torch.randn((3, n, c), generator=g, device=dev)
        got = gather_rows(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, gather_rows_plain(table, idx)):
            raise AssertionError(f"gather_rows ragged C={c}: kernel != plain")
    log(f"gather_rows ragged (B=3, N={n}, M={m}, C=1/3/4/8/64/68/128, indices in [-7, N+7)): "
        "bit-equal, clamped")
    return rows


# SHA-256 (first 16 hex digits) of the indices the first split kernel
# (per-slice register lists, then a merge kernel, the design before this one)
# returned on each input of :func:`split_inputs` at splits 2, recorded on an
# H100 by ``scripts/torch_knn_packed.py --split_digests`` on that tree:
# the redesigned kernel must return them bit for bit, floats included.
SPLIT_DIGESTS = {
    "int C=4 in [0, 8) self": "21be071b622d6509",
    "int C=4 in [0, 8) 1000 queries": "2ef17931fcc69c12",
    "int C=4 in [0, 16) self": "18460242c5d59d1b",
    "int C=4 in [0, 16) 1000 queries": "82dcd2648940a3c3",
    "int C=64 in [0, 2) self": "a2ce4daa3c7f5e9b",
    "int C=64 in [0, 2) 1000 queries": "b3fe1f7fbbe8782b",
    "int C=64 in [0, 16) self": "61202e85bb95670f",
    "int C=64 in [0, 16) 1000 queries": "c0e094e6f23be158",
    "float C=4 (blocks) self": "0839da88c87bc8df",
    "float C=4 (blocks) 1000 queries": "b319eabb66c9b71c",
    "float C=64 self": "f7eebdf82f78125d",
    "float C=64 1000 queries": "76b10ddd548acfc2",
}


def split_inputs(pts) -> list:
    """The split kNN's inputs, from seeds: (name, x, integer-valued, whether
    every distance fits the flat kernel's 18-bit keys, 1000 query rows of
    x): integers in [0, 8) and [0, 16) at C=4, [0, 2) and [0, 16) at C=64,
    the ``make_blocks`` points and normal C=64 features."""
    import torch

    dev = pts.device
    rng = np.random.default_rng(15)

    def ints(hi, c):
        return torch.from_numpy(rng.integers(0, hi, (B, N, c)).astype(np.float32)).to(dev)

    feats = torch.from_numpy(rng.standard_normal((B, N, 64), np.float32)).to(dev)
    cases = [(f"int C={c} in [0, {hi})", ints(hi, c), True, hi <= (8 if c == 4 else 2))
             for c in (4, 64) for hi in ((8, 16) if c == 4 else (2, 16))]
    cases += [("float C=4 (blocks)", pts, False, False), ("float C=64", feats, False, False)]
    rows = torch.from_numpy(rng.permutation(N)[:1000]).to(dev)
    return [(name, x, int_valued, fits, x[:, rows].contiguous())
            for name, x, int_valued, fits in cases]


def digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def phase_split(pts):
    """The split packed kNN (``knn_packed(..., splits=s)``) at B=8, N=7000,
    k=30, C=4 and C=64, splits 2 and 8, self and 1000 ``queries=``
    (:func:`split_inputs`): bit for bit equal to what the first split
    kernel returned (:data:`SPLIT_DIGESTS`), floats included, and across
    splits; on integers to its plain version too; where every distance fits
    the flat kernel's 18-bit keys (C=4 in [0, 8), C=64 in [0, 2)) also equal
    to the flat packed kernel; on ints in [0, 16) the two select
    differently on some rows (logged). Float inputs: against the plain
    version within the packed keys' tolerance (the kernel's ``fmaf`` chain
    and cuBLAS sum in other orders, so equal bits are not guaranteed
    there), the rows unlike the plain version's and the flat kernel's
    counted and logged. The self cases of three inputs are timed through
    the wrapper (:func:`cuda_ms_many`), the flat kernel on the same input
    beside them."""
    import torch

    from dgcnn_tpu_torch.kernels.knn_packed import knn_packed, knn_packed_split_plain

    rows = []
    for name, x, int_valued, fits, q in split_inputs(pts):
        for queries in (None, q):
            tag = "self" if queries is None else "1000 queries"
            flat = knn_packed(x, K, queries=queries)
            outs = {}
            for s in (2, 8):
                qq = x if queries is None else queries
                outs[s] = knn_packed(x, K, queries=queries, splits=s)
                want = knn_packed_split_plain(x, K, queries=queries)
                torch.cuda.synchronize()
                agree, err = _compare(f"knn_packed_split {name} {tag} splits {s}", x, qq,
                                      outs[s], want, int_valued)
                diff_flat = int((outs[s] != flat).any(-1).sum())
                diff_plain = int((outs[s] != want).any(-1).sum())
                if fits and diff_flat:
                    raise AssertionError(f"knn_packed_split {name} {tag}: {diff_flat} rows "
                                         "differ from the flat kernel where distances fit")
                row = {"case": f"{name} {tag} splits {s}", "max_abs_err": err,
                       "rows_unlike_plain": diff_plain, "rows_unlike_flat": diff_flat}
                if queries is None and name in ("int C=4 in [0, 16)", "float C=4 (blocks)",
                                                "float C=64"):
                    row["ms"] = cuda_ms_many(lambda s=s: knn_packed(x, K, splits=s), 10, 5)
                    row["flat_ms"] = cuda_ms_many(lambda: knn_packed(x, K), 10, 5)
                    row["plain_ms"] = cuda_ms(lambda: knn_packed_split_plain(x, K), 2)
                log(f"knn_packed_split {name} {tag} splits {s}: agreement {agree:.6f}, max "
                    f"|d2 diff| {err:.3e}, of {flat.shape[0] * flat.shape[1]} rows "
                    f"{diff_plain} unlike the plain version, {diff_flat} unlike the flat "
                    f"kernel; kernel {row.get('ms', float('nan')):.4f} ms, flat "
                    f"{row.get('flat_ms', float('nan')):.4f} ms, plain "
                    f"{row.get('plain_ms', float('nan')):.3f} ms")
                rows.append(row)
            if not torch.equal(outs[2], outs[8]):
                raise AssertionError(f"knn_packed_split {name} {tag}: splits 2 != splits 8")
            held = SPLIT_DIGESTS.get(f"{name} {tag}")
            if held is None or digest(outs[2]) != held:
                raise AssertionError(f"knn_packed_split {name} {tag}: indices {digest(outs[2])}"
                                     f", the first split kernel's {held}")
    log(f"knn_packed_split: every input's indices equal to the first split kernel's "
        f"({len(SPLIT_DIGESTS)} digests)")
    return rows


def path_split() -> dict:
    """Path B through its entry point, ``knn_packed(x, k, splits=s)``, the
    counters reset just before and read just after: splits 2 and 8, self
    and ``queries=``, at B=8 N=7000 C=64; then the routing cases that take
    the flat kernel."""
    import torch

    from dgcnn_tpu_torch.kernels.knn_packed import knn_packed

    dev = torch.device("cuda")
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.standard_normal((B, N, 64), np.float32)).to(dev)
    counters = reset_counters()
    for s in (2, 8):
        knn_packed(x, K, splits=s)
        knn_packed(x, K, queries=x[:, :1000], splits=s)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    if launches != {**{name: 0 for name in counters}, "knn_packed_split": 4}:
        raise AssertionError(f"[split path] launches {launches}")
    big = torch.from_numpy(rng.standard_normal((1, 9000, 4), np.float32)).to(dev)
    for label, run in (("splits=3, n_pad 7040", lambda: knn_packed(x, K, splits=3)),
                       ("splits=2, N=9000 (n_pad 9088 > 8192)",
                        lambda: knn_packed(big, K, splits=2))):
        reset_counters()
        run()
        if (counters["knn_packed"].launches, counters["knn_packed_split"].launches) != (1, 0):
            raise AssertionError(f"[split path] {label}: did not take the flat kernel")
        log(f"[split path] {label}: the flat packed kernel")
    log(f"[split path] splits 2 and 8, self and 1000 queries: launches {launches}")
    return launches


def phase_wrappers():
    """The banded wrappers' data fallbacks, on the card: a stage-1 batch
    whose far-off rows fail the certificate (repaired rows equal the exact
    kNN), an unsorted batch (equals the capped kNN), decorrelated features
    under a guarded call (trips, equals the capped kNN)."""
    import torch

    from dgcnn_tpu_torch.kernels.knn_banded import (
        knn_banded, knn_banded_raw, knn_feature_banded)
    from dgcnn_tpu_torch.kernels.knn_capped import knn_capped
    from dgcnn_tpu_torch.kernels.knn_exact import knn_exact, knn_exact_plain

    dev = torch.device("cuda")
    stage1 = dict(band=2048, capped_cap=8, **BANDS)
    pts = int_cloud(B, N, seed=11)
    pts[:, ::600, 1] += 500.0  # 12 rows per block far off in y
    x = torch.from_numpy(pts).to(dev)
    before = knn_exact.launches
    got = knn_banded(x, K, **stage1)
    raw, _ = knn_banded_raw(x, K, band=2048, query_tile=512, **BANDS)
    fixed = (got != raw).any(-1)
    exact = knn_exact_plain(x, K)
    if knn_exact.launches != before + 1 or int(fixed.sum()) < B:
        raise AssertionError(f"repair: {int(fixed.sum())} rows repaired, "
                             f"{knn_exact.launches - before} exact launches")
    if not torch.equal(got[fixed], exact[fixed]):
        raise AssertionError("repair: repaired rows differ from the exact kNN")
    log(f"knn_banded repair: {int(fixed.sum())} rows repaired, equal to the exact kNN")

    shuffled = x[:, torch.randperm(N, device=dev)]
    if not torch.equal(knn_banded(shuffled, K, **stage1), knn_capped(shuffled, K)):
        raise AssertionError("unsorted batch: knn_banded != knn_capped")
    log("knn_banded unsorted batch: equal to the capped kNN")

    rng = np.random.default_rng(12)
    f = torch.from_numpy(rng.integers(0, 31, (B, N, 64)).astype(np.float32)).to(dev)
    idx, tripped = knn_feature_banded(
        f, K, sorted_ok=torch.ones((), dtype=torch.bool, device=dev), band=4096,
        capped_cap=8, guard_ok=True, with_flag=True, **BANDS)
    if not bool(tripped) or not torch.equal(idx, knn_capped(f, K)):
        raise AssertionError(f"decorrelated features: tripped={bool(tripped)}, "
                             "or the result is not the capped kNN")
    log("knn_feature_banded decorrelated features: tripped, equal to the capped kNN")


def phase_parity_wrappers():
    """The parity wrapper (``knn_exact_banded``) on the card is bit for bit
    the flat exact kernel on the card, on float inputs: ``make_blocks``
    batches at stage 1 (band 2048) and C=64 feature tables at full width
    (band 0); then through its fallbacks, with the launches of each case
    asserted: a forced repair (far-off rows fail the band-edge
    certificate), a window overflow (a residue-class cluster deeper than
    cap 8 in one window), a budget overflow (all x equal: every query
    fails, the flat kernel runs) and an unsorted batch (full width)."""
    import torch

    from dgcnn_tpu_torch.kernels.knn_exact import knn_exact
    from dgcnn_tpu_torch.kernels.knn_exact_banded import (
        knn_exact_banded, knn_exact_banded_raw)

    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    blocks = make_blocks(B, N, seed=13)
    far = blocks.copy()
    far[:, ::600, 1] += 500.0  # 12 rows per block far off in y
    cluster = np.zeros((B, N, 3), np.float32)
    cluster[..., 0] = np.arange(N) * 1e-3
    cluster[..., 1] = 100.0
    cluster[:, 3::64, 1] = 0.0  # rows r = 3 (mod 64): all in window 3
    flat_x = blocks.copy()
    flat_x[..., 0] = 1.0
    cases = [
        # name, points, band, (raw launches, exact launches), repairs expected
        ("make_blocks stage 1", blocks, 2048, (1, 2), None),
        ("C=64 features band 0", rng.standard_normal((B, N, 64)).astype(np.float32), 0,
         (1, 2), None),
        ("forced repair", far, 2048, (1, 2), "certificate"),
        ("window overflow", cluster, 2048, (1, 2), "overflow"),
        ("budget overflow", flat_x, 2048, (1, 2), "budget"),
        ("unsorted batch", blocks[:, rng.permutation(N)], 2048, (1, 2), None),
    ]
    out = {}
    for name, pts, band, want_launches, expect in cases:
        x = torch.from_numpy(np.ascontiguousarray(pts)).to(dev)
        before = (knn_exact_banded_raw.launches, knn_exact.launches)
        got = knn_exact_banded(x, K, band=band)
        launches = (knn_exact_banded_raw.launches - before[0], knn_exact.launches - before[1])
        want = knn_exact(x, K)
        torch.cuda.synchronize()
        raw, _, ovf = knn_exact_banded_raw(x, K, band=band or -(-N // 128) * 128, n_win=64,
                                           cap=8, query_tile=256)
        changed = int((raw != got).any(-1).sum())
        info = f"{changed} rows differ from the raw kernel, {int(ovf.sum())} overflow flags"
        if launches != want_launches or not torch.equal(got, want):
            raise AssertionError(f"parity wrapper, {name}: launches {launches}, equal to the "
                                 f"flat exact kernel: {torch.equal(got, want)}; {info}")
        if expect == "overflow" and not ovf.any():
            raise AssertionError(f"parity wrapper, {name}: no window overflowed")
        if expect in ("certificate", "budget") and not changed:
            raise AssertionError(f"parity wrapper, {name}: nothing was repaired")
        log(f"knn_exact_banded wrapper, {name}: bit-equal to the flat exact kernel; {info}; "
            f"launches {launches}")
        out[name] = {"changed_rows": changed, "overflow_flags": int(ovf.sum())}
    return out


def write_tile(path: str, seed: int, extent=(120.0, 60.0), n: int = 70000) -> None:
    """Synthetic airborne tile: sloped terrain, vegetation, buildings."""
    from dgcnn_tpu_torch.io.las import write_las

    rng = np.random.default_rng(seed)
    xy = rng.random((n, 2)) * np.asarray(extent)
    ground = 0.03 * xy[:, 0] + 0.02 * xy[:, 1]
    z = ground + rng.normal(0, 0.05, n)
    cls = np.full(n, 2)
    veg = rng.random(n) < 0.3
    z[veg] += rng.random(veg.sum()) * 12 + 0.8
    cls[veg] = 5
    for bx, by in ((15.0, 10.0), (60.0, 30.0), (95.0, 12.0)):
        inb = ((xy[:, 0] > bx) & (xy[:, 0] < bx + 14) & (xy[:, 1] > by)
               & (xy[:, 1] < by + 14) & ~veg)
        z[inb] = ground[inb] + 7.0
        cls[inb] = 6
    write_las(path, xy[:, 0] + 5e5, xy[:, 1] + 6e6, z, cls)


def write_checkpoint(path: str, cfg, seed: int) -> None:
    """Seeded full-width weights with non-trivial BN statistics, written
    in the JAX package's .npz layout."""
    import torch

    from dgcnn_tpu_torch.models.dgcnn import init_dgcnn
    from dgcnn_tpu_torch.train.checkpoint import write_leaves

    model = init_dgcnn(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    named = {}
    for key, v in model.state_dict().items():
        name, leaf = key.split(".")
        c = v.shape[0]
        if leaf == "gamma":
            v = torch.from_numpy(rng.uniform(0.5, 1.5, c) * rng.choice([-1.0, 1.0], c))
        elif leaf == "beta":
            v = torch.from_numpy(rng.normal(0.0, 0.2, c))
        elif leaf == "mean":
            v = torch.from_numpy(rng.normal(0.0, 0.3, c))
        elif leaf == "var":
            v = torch.from_numpy(rng.uniform(0.5, 2.0, c))
        field = "bn_state" if leaf in ("mean", "var") else "params"
        named[f"{field}/{name}/{leaf}"] = v.numpy().astype(np.float32)
    write_leaves(path, named)


def _counters():
    from dgcnn_tpu_torch.kernels.edgeconv_fused import (
        edgeconv_fused_extrema, edgeconv_fused_stage, edgeconv_fused_stage_bf16)
    from dgcnn_tpu_torch.kernels.knn_banded import knn_banded_raw
    from dgcnn_tpu_torch.kernels.knn_capped import knn_capped
    from dgcnn_tpu_torch.kernels.knn_exact import knn_exact
    from dgcnn_tpu_torch.kernels.knn_exact_banded import knn_exact_banded_raw
    from dgcnn_tpu_torch.kernels.gather_rows import gather_rows
    from dgcnn_tpu_torch.kernels.knn_packed import _knn_packed_split, knn_packed
    from dgcnn_tpu_torch.kernels.scatter_rows import (
        scatter_add_rows, scatter_stage_tail_rows)

    return {"knn_capped": knn_capped, "edgeconv_fused_stage": edgeconv_fused_stage,
            "edgeconv_fused_stage_bf16": edgeconv_fused_stage_bf16,
            "edgeconv_fused_extrema": edgeconv_fused_extrema,
            "knn_banded": knn_banded_raw, "knn_exact": knn_exact,
            "knn_exact_banded": knn_exact_banded_raw, "knn_packed": knn_packed,
            "knn_packed_split": _knn_packed_split,
            "scatter_add_rows": scatter_add_rows,
            "scatter_stage_tail_rows": scatter_stage_tail_rows,
            "gather_rows": gather_rows}


def reset_counters() -> dict:
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def serve_tiles(tmp: str, tag: str, tiles: dict, model_root: str | None = None,
                **knn_kwargs):
    """Serve ``tiles`` ({name: (seed, extent, n)}) through the port's
    PredictService at full width, the launch counters reset just before
    and read just after. Returns (launches, batches per tile)."""
    import torch

    from dgcnn_tpu_torch.io.las import read_las
    from dgcnn_tpu_torch.prepare.tile_load import load_tile_las
    from dgcnn_tpu_torch.utils.logging import IOStream
    from dgcnn_tpu_torch.serve.service import PredictService, serve_directory

    landing, out = os.path.join(tmp, tag, "landing"), os.path.join(tmp, tag, "out")
    os.makedirs(landing)
    for name, (seed, extent, n) in tiles.items():
        write_tile(os.path.join(landing, f"{name}.las"), seed, extent, n)
    first = os.path.join(landing, f"{next(iter(tiles))}.las")
    fused_load = load_tile_las(first) is not None
    log(f"[{tag}] tile load: {'fused native tile load' if fused_load else 'separate-stage Python chain'}")
    service = PredictService(
        K, io=IOStream(os.path.join(tmp, f"{tag}.log"), stream=sys.stderr),
        num_points=N, block_size=30.0, emb_dims=1024, batch_size=B,
        model_root=model_root or os.path.join(tmp, "ckpt"), device="cuda", **knn_kwargs)
    counters = reset_counters()
    t0 = time.perf_counter()
    done = serve_directory(service, landing, out, once=True, settle_s=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    if done != len(tiles) or service.processed != len(tiles) or service.failed != 0:
        raise AssertionError(f"[{tag}] served {done} tiles, {service.processed} ok, "
                             f"{service.failed} failed (see {out}/failed)")
    batches = {}
    for name in tiles:
        stats = json.loads(open(os.path.join(out, f"{name}.las.json")).read())
        las = read_las(os.path.join(out, f"{name}.las"))
        labels = set(np.unique(las.classification).tolist())
        if len(las) != stats["points"] or not labels <= set(range(5)) | {31}:
            raise AssertionError(f"[{tag}] {name}: bad output {len(las)} pts, labels {labels}")
        n_blocks = stats["block_points"] // N
        batches[name] = -(-n_blocks // B)
        log(f"[{tag}] {name}: {stats['points']} points in {n_blocks} blocks, "
            f"{stats['seconds']} s, {stats['points_per_sec']} pts/s, labels {sorted(labels)}")
    log(f"[{tag}] served {len(tiles)} tiles ({sum(batches.values())} batches) in "
        f"{wall:.2f} s; launches {launches}")
    return launches, batches


def phase_serve(tmp: str):
    """The capped-only path on one tile, then the default path on four."""
    from dgcnn_tpu_torch.models.dgcnn import DGCNNConfig

    write_checkpoint(os.path.join(tmp, "ckpt", "dgcnn_model.npz"),
                     DGCNNConfig(k=K, emb_dims=1024), seed=0)
    small = {f"tile{i}": (100 + i, (120.0, 60.0), 70000) for i in range(3)}

    launches, batches = serve_tiles(tmp, "capped", {"tile0": small["tile0"]},
                                    knn_impl="pallas_capped", knn_band=0,
                                    knn_band_feature=0)
    nb = sum(batches.values())
    none = {name: 0 for name in _counters()}
    want = {**none, "knn_capped": 3 * nb, "edgeconv_fused_stage": 2 * nb,
            "edgeconv_fused_extrema": nb}
    if launches != want:
        raise AssertionError(f"[capped] launches {launches} != {want}")
    capped_launches = launches

    # the parity mode: per forward 3 exact banded kNNs and, behind each, 2
    # predicated exact kNNs (the repair and the flat fallback)
    mode_launches = {}
    for tag, impl, want_knn in (("parity", "pallas", {"knn_exact_banded": 3, "knn_exact": 6}),
                                ("packed", "pallas_packed", {"knn_packed": 3})):
        launches, batches = serve_tiles(tmp, tag, {"tile1": small["tile1"]}, knn_impl=impl)
        nb = sum(batches.values())
        want = {**none, "edgeconv_fused_stage": 2 * nb, "edgeconv_fused_extrema": nb,
                **{name: n * nb for name, n in want_knn.items()}}
        if launches != want:
            raise AssertionError(f"[{tag}] launches {launches} != {want}")
        mode_launches[tag] = launches

    # the bf16 serving configuration (default kNN): per forward two bf16
    # stage launches and no FP32 stage launch
    launches, batches = serve_tiles(tmp, "bf16", {"tile2": small["tile2"]},
                                    compute_dtype="bfloat16")
    nb, fwd = sum(batches.values()), launches["knn_banded"] // 3
    if (fwd < nb or launches["edgeconv_fused_stage_bf16"] != 2 * fwd
            or launches["edgeconv_fused_stage"] != 0
            or launches["edgeconv_fused_extrema"] != fwd):
        raise AssertionError(f"[bf16] launches {launches} for {nb} batches")
    log(f"[bf16] {fwd} forwards for {nb} batches: {launches['edgeconv_fused_stage_bf16']} "
        "bf16 stage launches, no FP32 stage launch")
    mode_launches["bf16"] = launches

    # ~9.7 points/m^2 as the small tiles: 9 x 8 blocks of 30 m, 9 batches
    tiles = {**small, "tile_big": (200, (270.0, 240.0), 630000)}
    launches, batches = serve_tiles(tmp, "default", tiles)
    nb = sum(batches.values())
    # every forward launches 3 banded kNNs, 1 exact (the stage-1 repair,
    # predicated) and 3 capped (the fallbacks, predicated); a guarded one
    # adds 4 capped probes (2 stages x 2 probe stages, the second
    # predicated). Each tile's first dispatch is guarded, then every 8th.
    fwd = launches["knn_banded"] // 3
    guarded = (launches["knn_capped"] - 3 * fwd) / 4
    want_guarded = sum(-(-b // 8) for b in batches.values())
    log(f"[default] {fwd} forwards for {nb} batches; {guarded} guarded "
        f"(expected without a trip: {nb} and {want_guarded})")
    if (launches["knn_banded"] != 3 * fwd or fwd < nb or launches["knn_exact"] != fwd
            or launches["edgeconv_fused_stage"] != 2 * fwd
            or launches["edgeconv_fused_extrema"] != fwd
            or guarded != int(guarded) or not len(tiles) <= guarded < fwd):
        raise AssertionError(f"[default] launches {launches} for {nb} batches")
    if batches["tile_big"] < 9:
        raise AssertionError(f"[default] the big tile made {batches['tile_big']} batches, not 9")
    return capped_launches, launches, mode_launches


def phase_no_sync():
    """Guarded and unguarded predict steps and one forward of the default
    configuration with host syncs turned into errors."""
    import torch

    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn
    from dgcnn_tpu_torch.train.steps import make_guarded_predict_step

    model = init_dgcnn(DGCNNConfig(k=K, emb_dims=1024), torch.Generator().manual_seed(3),
                       device="cuda")
    x = torch.from_numpy(make_blocks(B, N, seed=4)).to("cuda")
    step, sched = make_guarded_predict_step(model.cfg, "cuda")
    modes = {}
    for name, kw in (("pallas", dict(knn_impl="pallas")),
                     ("pallas_packed", dict(knn_impl="pallas_packed")),
                     ("bf16", dict(compute_dtype="bfloat16"))):
        modes[name] = DGCNN(dataclasses.replace(model.cfg, **kw)).to("cuda")
        modes[name].load_state_dict(model.state_dict())
    with torch.inference_mode():
        model(x)
        for m in modes.values():
            m(x)
    for _ in range(2):
        step(model, x)
    torch.cuda.synchronize()
    sched.rearm()  # the next dispatch is guarded, the one after is not
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            step(model, x)
        with torch.inference_mode():
            model(x)
            for m in modes.values():
                m(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if sched.tripped:
        raise AssertionError("no-sync steps: the recall guard tripped on bench blocks")
    log("no host sync: a guarded and an unguarded predict step, a guarded "
        "forward and a parity-mode, a packed-mode and a bf16 default forward ran "
        "under set_sync_debug_mode('error')")


def phase_forward():
    """The GPU forward against the CPU plain versions, default and
    capped-only configurations (parity, packed, bf16 too), and their times
    on a bench-style batch; the bf16 forward's argmax agreement with the
    FP32 one there."""
    import torch

    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn

    default = DGCNNConfig(k=K, emb_dims=1024)
    bf16 = DGCNNConfig(k=K, emb_dims=1024, compute_dtype="bfloat16")
    capped = DGCNNConfig(k=K, emb_dims=1024, knn_impl="pallas_capped", knn_band=0,
                         knn_band_feature=0)
    parity = DGCNNConfig(k=K, emb_dims=1024, knn_impl="pallas")
    packed = DGCNNConfig(k=K, emb_dims=1024, knn_impl="pallas_packed")
    weights = init_dgcnn(default, torch.Generator().manual_seed(1)).state_dict()
    diffs = {}
    # on the CPU "auto" is the exact kNN: the plain twin names the banded
    # path; blocks of 5000 rows exceed the 4096-row feature band and the
    # parity mode's 2048-row stage-1 band
    for name, cfg, plain_cfg, shape in (
            ("default", default, dataclasses.replace(default, knn_impl="pallas_capped"),
             (2, 5000)),
            ("capped", capped, capped, (2, 2048)),
            ("parity", parity, parity, (2, 5000)),
            ("packed", packed, packed, (2, 2048)),
            ("bf16", bf16, dataclasses.replace(bf16, knn_impl="pallas_capped"), (2, 5000))):
        gpu, cpu = DGCNN(cfg), DGCNN(plain_cfg)
        gpu.load_state_dict(weights)
        cpu.load_state_dict(weights)
        small = torch.from_numpy(make_blocks(*shape, seed=2))
        with torch.inference_mode():
            want = torch.softmax(cpu(small), -1)
            got = torch.softmax(gpu.to("cuda")(small.to("cuda")), -1).cpu()
        diffs[name] = (got - want).abs().max().item()
        if not diffs[name] <= 1e-3:  # the north-star per-point probability budget
            raise AssertionError(f"{name}: GPU forward vs CPU plain: max prob diff {diffs[name]}")
        log(f"{name} forward {shape}: GPU vs CPU plain max prob diff {diffs[name]:.2e}")

    models = {name: DGCNN(cfg).to("cuda") for name, cfg in (
        ("default", default), ("capped", capped), ("parity", parity), ("packed", packed),
        ("bf16", bf16))}
    for m in models.values():
        m.load_state_dict(weights)
    x = torch.from_numpy(make_blocks(B, N, seed=0)).to("cuda")
    runs = {"default guarded": lambda: models["default"](x, band_mode=1),
            "default unguarded": lambda: models["default"](x, band_mode=0),
            "capped": lambda: models["capped"](x),
            "parity": lambda: models["parity"](x),
            "packed": lambda: models["packed"](x),
            "bf16 guarded": lambda: models["bf16"](x, band_mode=1),
            "bf16 unguarded": lambda: models["bf16"](x, band_mode=0)}
    ms = {}
    with torch.inference_mode():
        logits, tripped = models["default"](x, band_mode=1, with_band_flag=True)
        for name, fn in runs.items():
            out = fn()
            if out.shape != (B, N, 5) or not torch.isfinite(out).all():
                raise AssertionError(f"{name} forward gave {tuple(out.shape)}, finite="
                                     f"{bool(torch.isfinite(out).all())}")
            ms[name] = cuda_ms(fn, 10)
            log(f"forward {name} B={B} N={N} k={K} emb=1024: {ms[name]:.3f} ms/batch "
                f"({B * N / ms[name] * 1e3:.0f} pts/s)")
    log(f"default forward guard on bench blocks: tripped={bool(tripped)}")
    # the bf16 forward against the FP32 one on the production batch
    with torch.inference_mode():
        p32 = torch.softmax(models["default"](x, band_mode=0), -1)
        p16 = torch.softmax(models["bf16"](x, band_mode=0), -1)
    diffs["bf16_vs_f32_argmax_agreement"] = (p32.argmax(-1) == p16.argmax(-1)).float().mean().item()
    diffs["bf16_vs_f32_max_prob_diff"] = (p32 - p16).abs().max().item()
    log(f"bf16 forward against the FP32 one (B={B} N={N}): argmax agreement "
        f"{diffs['bf16_vs_f32_argmax_agreement']:.6f}, max prob diff "
        f"{diffs['bf16_vs_f32_max_prob_diff']:.3e}; unguarded {ms['bf16 unguarded']:.3f} "
        f"against {ms['default unguarded']:.3f} ms/batch")
    return ms, diffs


def write_rooms(root: str, n_rooms: int, n_points: int, seed: int) -> None:
    """Training rooms ``Area_<i>.npy`` (x, y, z, agl, label): 30 m blocks
    cut from synthetic airborne scenes like ``write_tile``'s, with labels
    tied to geometry — ground (0), low and high vegetation (1, 2: below
    and above 3 m), building roofs (3), and isolated low points (4)."""
    rng = np.random.default_rng(seed)
    for i in range(n_rooms):
        xy = rng.random((n_points, 2)) * 30.0
        ground = 0.03 * xy[:, 0] + 0.02 * xy[:, 1]
        agl = np.abs(rng.normal(0, 0.05, n_points))
        label = np.zeros(n_points, np.int64)
        veg = rng.random(n_points) < 0.3
        agl[veg] = rng.random(veg.sum()) * 12 + 0.8
        label[veg] = np.where(agl[veg] < 3.0, 1, 2)
        bx, by = rng.uniform(2.0, 14.0, 2)
        roof = ((xy[:, 0] > bx) & (xy[:, 0] < bx + 14) & (xy[:, 1] > by)
                & (xy[:, 1] < by + 14) & ~veg)
        agl[roof] = 7.0 + rng.normal(0, 0.03, roof.sum())
        label[roof] = 3
        other = (rng.random(n_points) < 0.03) & ~veg & ~roof
        agl[other] = rng.random(other.sum()) * 0.5 + 0.2
        label[other] = 4
        room = np.column_stack([xy, ground + agl, agl, label]).astype(np.float32)
        np.save(os.path.join(root, f"Area_{i}.npy"), room)


def replay_knn(src, dst) -> None:
    """Record the neighbour indices of ``src``'s next forward (a port
    ``DGCNN``) and hand them, stage by stage, to ``dst``'s next forward.
    The card's and the CPU's FP32 features differ in the last bits, so each
    side's own kNN can pick another neighbour at a near-tie (the kNN
    kernels are held against their plain versions in phase 2); replaying
    the card's graph makes the gradients differ by sum order only."""
    seen = []

    def record(*args, **kwargs):
        seen.append(type(src)._knn(src, *args, **kwargs))
        return seen[-1]

    def replay(x, *args, **kwargs):
        return seen.pop(0).to(x.device)

    src._knn, dst._knn = record, replay


def _rel(got, want, floor: float) -> float:
    return (got - want).norm().item() / max(want.norm().item(), floor)


def phase_train(tmp: str):
    """The port's trainer at full width on the card: launch counts, the
    loss on a fixed batch, the step time and peak memory, the gradients
    against the CPU plain versions, and serving the trained checkpoint."""
    import torch

    from dgcnn_tpu_torch.data.dataset import FugroDataset
    from dgcnn_tpu_torch.data.prefetch import to_device
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn
    from dgcnn_tpu_torch.ops.losses import masked_smoothed_cross_entropy
    from dgcnn_tpu_torch.train.loop import train
    from dgcnn_tpu_torch.train.steps import (
        BandGuardScheduler, init_train_state, make_train_step)
    from dgcnn_tpu_torch.utils.logging import IOStream

    rooms, root = os.path.join(tmp, "rooms"), os.path.join(tmp, "trained")
    os.makedirs(rooms)
    n_rooms, epochs = 20, 2
    write_rooms(rooms, n_rooms, 12000, seed=5)
    io = IOStream(os.path.join(tmp, "train.log"), stream=sys.stderr)
    counters = reset_counters()
    t0 = time.perf_counter()
    summary = train(K, io, data_dir=rooms, num_points=N, epochs=epochs, train_batch_size=B,
                    validation_batch_size=B, emb_dims=1024, model_root=root,
                    tb_dir=os.path.join(tmp, "tb"), seed=1, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    n_val = int(np.floor(n_rooms * 0.2))
    steps = epochs * ((n_rooms - n_val) // B)
    val_batches = epochs * -(-n_val // B)
    log(f"[train] train() {epochs} epochs, {steps} steps + {val_batches} validation batches "
        f"in {wall:.2f} s: {summary}; launches {launches}")
    # per step: 3 forward gathers (stage 1 at C=4, stages 2-3 at C=64; the
    # validation forwards take the fused kernels), stage 2's gather VJP
    # (stage 1 gathers the input points, which need no gradient) and stage
    # 3's tail; 3 banded kNNs per forward
    want = {"gather_rows": 3 * steps, "scatter_add_rows": steps,
            "scatter_stage_tail_rows": steps, "knn_banded": 3 * (steps + val_batches)}
    if any(launches[k_] != v for k_, v in want.items()):
        raise AssertionError(f"[train] launches {launches}, expected {want}")
    if not os.path.exists(os.path.join(root, "dgcnn_model.npz")) \
            or not summary.get("best_balanced_accuracy", 0) > 0:
        raise AssertionError(f"[train] no checkpoint written ({summary})")
    train_launches = launches

    # 20 steps on one fixed batch, as the loop runs them
    cfg = DGCNNConfig(k=K, emb_dims=1024)
    data = FugroDataset("train", rooms, num_point=N, seed=1)
    batch = next(data.batches(B, epoch=0))
    pts, labels, mask = to_device((batch.points, batch.labels, batch.mask), "cuda")
    state = init_train_state(cfg, seed=2, device="cuda", epochs=30)
    sched = BandGuardScheduler(cfg, "cuda")
    step = make_train_step(cfg, band_guard=sched.active)
    counters = reset_counters()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        mode, guarded = sched.next_mode() if sched.active else (None, False)
        metrics = step(state, pts, labels, mask, mode)
        if guarded:
            loss, flag = torch.stack([metrics["loss"], metrics["band_tripped"].float()]).tolist()
            sched.observe(bool(flag))
        else:
            loss = float(metrics["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_launches = {name: fn.launches / 20 for name, fn in counters.items()}
    step_ms = float(np.median(times[10:]))
    log(f"[train] fixed batch losses {[round(v, 4) for v in losses]}")
    log(f"[train] step B={B} N={N} k={K} emb=1024: median {step_ms:.3f} ms of steps 11-20 "
        f"({B * N / step_ms * 1e3:.0f} pts/s), all {[round(v, 2) for v in times]}; "
        f"peak memory {peak_gb:.3f} GB; launches per step {step_launches}")
    if not all(np.isfinite(losses)) or not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"[train] the loss did not fall on a fixed batch: {losses}")
    if (step_launches["gather_rows"], step_launches["scatter_add_rows"],
            step_launches["scatter_stage_tail_rows"], step_launches["knn_banded"]) != (3, 1, 1, 3):
        raise AssertionError(f"[train] launches per step {step_launches}")
    # grad_accum=2: each micro-batch runs the path
    counters = reset_counters()
    make_train_step(cfg, grad_accum=2)(state, pts, labels, mask)
    torch.cuda.synchronize()
    if (counters["gather_rows"].launches, counters["scatter_add_rows"].launches,
            counters["scatter_stage_tail_rows"].launches,
            counters["knn_banded"].launches) != (6, 2, 2, 6):
        raise AssertionError("[train] grad_accum=2 launches "
                             f"{ {k_: fn.launches for k_, fn in counters.items()} }")

    # one step's gradients on the card against the CPU plain versions
    gcfg = DGCNNConfig(k=K, emb_dims=1024, dropout=0.0)
    weights = init_dgcnn(gcfg, torch.Generator().manual_seed(3)).state_dict()
    shape = (2, 2048)
    small = torch.from_numpy(make_blocks(*shape, seed=6))
    rng = np.random.default_rng(6)
    lab = torch.from_numpy(rng.integers(0, 5, shape))
    msk = torch.from_numpy((rng.random(shape) < 0.7).astype(np.float32))
    grads, losses_gc = {}, {}
    # on the CPU "auto" is the exact kNN: the plain twin names the banded path
    models = {dev: DGCNN(c) for dev, c in (
        ("cuda", gcfg), ("cpu", dataclasses.replace(gcfg, knn_impl="pallas_capped")))}
    replay_knn(models["cuda"], models["cpu"])
    for dev, model in models.items():
        model.load_state_dict(weights)
        model = model.to(dev).train()
        loss = masked_smoothed_cross_entropy(model(small.to(dev)), lab.to(dev), msk.to(dev))
        loss.backward()
        losses_gc[dev] = loss.item()
        grads[dev] = {k_: p_.grad.cpu() for k_, p_ in model.named_parameters()}
    floor = 1e-3 * max(g_.norm().item() for g_ in grads["cpu"].values())
    rels = {k_: _rel(grads["cuda"][k_], grads["cpu"][k_], floor) for k_ in grads["cpu"]}
    worst = max(rels, key=rels.get)
    log(f"[train] gradients (2, 2048) GPU vs CPU plain: loss {losses_gc['cuda']:.7f} vs "
        f"{losses_gc['cpu']:.7f}, worst leaf {worst} rel {rels[worst]:.2e}")
    # atomics and cuBLAS add in another order than the CPU: the CPU tests'
    # budget against JAX (tests/test_torch_train.py)
    if rels[worst] > 1e-2 or abs(losses_gc["cuda"] - losses_gc["cpu"]) > 1e-4:
        raise AssertionError(f"[train] GPU vs CPU gradients: {rels}")

    # serve one tile with the checkpoint the trainer wrote
    served, _ = serve_tiles(tmp, "trained", {"tile": (300, (120.0, 60.0), 70000)},
                            model_root=root)
    return {"steps": steps, "train_wall_s": wall, "launches": train_launches,
            "fixed_batch_losses": losses, "step_ms": step_ms, "step_ms_all": times,
            "points_per_s": B * N / step_ms * 1e3, "peak_memory_gb": peak_gb,
            "launches_per_step": step_launches, "grad_rel_worst": rels[worst],
            "served_launches": served, "parity": train_parity(pts, labels, mask),
            "device_masks": train_device_masks(tmp, rooms)}


def train_parity(pts, labels, mask, steps: int = 10) -> dict:
    """``steps`` train steps of the parity mode (``knn_impl="pallas"``: the
    exact banded kNN, no recall guard) at full width on one fixed batch:
    the loss falls, the launches per step (3 exact banded kNNs, each with
    its 2 predicated exact kNNs; 3 gathers; stage 2's gather VJP; stage
    3's tail), the
    median step time of the last half and the peak device memory."""
    import torch

    from dgcnn_tpu_torch.models.dgcnn import DGCNNConfig
    from dgcnn_tpu_torch.train.steps import (
        BandGuardScheduler, init_train_state, make_train_step)

    cfg = DGCNNConfig(k=K, emb_dims=1024, knn_impl="pallas")
    if BandGuardScheduler(cfg, "cuda").active:
        raise AssertionError("[train parity] the recall guard is armed in the parity mode")
    state = init_train_state(cfg, seed=2, device="cuda", epochs=30)
    step = make_train_step(cfg)
    counters = reset_counters()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(state, pts, labels, mask)["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {name: fn.launches / steps for name, fn in counters.items()}
    step_ms = float(np.median(times[steps // 2:]))
    log(f"[train parity] fixed batch losses {[round(v, 4) for v in losses]}")
    log(f"[train parity] step B={B} N={N} k={K} emb=1024: median {step_ms:.3f} ms of the "
        f"last {steps - steps // 2} ({B * N / step_ms * 1e3:.0f} pts/s), all "
        f"{[round(v, 2) for v in times]}; peak memory {peak_gb:.3f} GB; launches per step "
        f"{per_step}")
    if not all(np.isfinite(losses)) or not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"[train parity] the loss did not fall on a fixed batch: {losses}")
    want = {"knn_exact_banded": 3, "knn_exact": 6, "gather_rows": 3, "scatter_add_rows": 1,
            "scatter_stage_tail_rows": 1, "knn_banded": 0, "knn_capped": 0, "knn_packed": 0}
    if any(per_step[k_] != v for k_, v in want.items()):
        raise AssertionError(f"[train parity] launches per step {per_step}, expected {want}")
    return {"fixed_batch_losses": losses, "step_ms": step_ms, "step_ms_all": times,
            "points_per_s": B * N / step_ms * 1e3, "peak_memory_gb": peak_gb,
            "launches_per_step": per_step}


def train_device_masks(tmp: str, rooms: str) -> dict:
    """``train(..., device_masks=True)`` at full width on phase 7's rooms:
    5 steps (5 epochs of one step: half the rooms are the validation
    split), class 4 excluded. Each mask the card draws in a step holds
    exactly m points of every considered class (m = min(smallest count,
    floor(N / C))) and none of class 4, and is ``torch.equal`` to the CPU
    plain version's on the same uniforms (the card's generator state
    replayed); every epoch's loss is finite."""
    import torch

    from dgcnn_tpu_torch.ops.masks import balanced_train_mask_from_u
    from dgcnn_tpu_torch.train import steps as steps_mod
    from dgcnn_tpu_torch.train.loop import train
    from dgcnn_tpu_torch.utils.logging import IOStream

    real, drawn = steps_mod.balanced_train_mask, []

    def record(labels, num_classes, exclude, generator):
        state = generator.get_state()
        mask = real(labels, num_classes, exclude, generator)
        drawn.append((labels.clone(), state, mask.clone(), tuple(exclude)))
        return mask

    log_path = os.path.join(tmp, "masked.log")
    steps_mod.balanced_train_mask = record
    try:
        t0 = time.perf_counter()
        train(K, IOStream(log_path, stream=sys.stderr), data_dir=rooms, num_points=N,
              epochs=5, train_batch_size=B, validation_batch_size=B, emb_dims=1024,
              model_root=os.path.join(tmp, "masked"), tb_dir=os.path.join(tmp, "tb_masked"),
              validation_prop=0.5, exclude_classes=(4,), device_masks=True, seed=1,
              device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        steps_mod.balanced_train_mask = real
    losses = [float(line.split("loss: ")[1].split(",")[0])
              for line in open(log_path) if line.startswith("Train ")]
    picked = []
    for labels, state, mask, exclude in drawn:
        gen = torch.Generator(device="cuda")
        gen.set_state(state)
        u = torch.rand(labels.shape, generator=gen, device="cuda")
        cpu = balanced_train_mask_from_u(labels.cpu(), u.cpu(), 5, exclude)
        if exclude != (4,) or not torch.equal(mask.cpu(), cpu):
            raise AssertionError("[train masks] the card's mask differs from the CPU's")
        for row in range(labels.shape[0]):
            counts = torch.bincount(labels[row].cpu(), minlength=5)
            m = min(int(counts[:4].min()), N // 5)
            got = torch.bincount(labels[row][mask[row] > 0].cpu(), minlength=5).tolist()
            if got != [m] * 4 + [0]:
                raise AssertionError(f"[train masks] per-class counts {got}, m = {m}")
            picked.append(m)
    log(f"[train masks] train(device_masks=True) {len(drawn)} steps in {wall:.2f} s: "
        f"losses {losses}, masked points per class {picked}, each mask equal to the CPU's")
    n_rooms = len([f for f in os.listdir(rooms) if f.endswith(".npy")])
    steps = 5 * ((n_rooms - n_rooms // 2) // B)  # 5 at B=8 on phase 7's 20 rooms
    if len(drawn) != steps or len(losses) != 5 or not np.isfinite(losses).all():
        raise AssertionError(f"[train masks] {len(drawn)} masks, losses {losses}")
    return {"steps": len(drawn), "losses": losses, "per_class": picked, "wall_s": wall}


def phase_eval(tmp: str) -> dict:
    """Phase 8: ``python -m dgcnn_tpu_torch.train --eval 1`` in-process on
    the card, at full width, on phase 7's trained checkpoint and rooms (16
    of the 20 rooms as the test partition: two batches of 8), at
    confidence threshold 0, so that every point carries the model's class
    (after 2 epochs no point reaches the default 0.8 and all would be
    UNCLASSIFIED). Then the same ``test()`` on the CPU plain versions of
    the banded path (``knn_impl="pallas_capped"`` with the default bands:
    on the CPU ``auto`` names the exact kNN): the per-point predictions
    may differ where the devices' kNNs break near-ties differently, in at
    most 0.05% of the points. Then a forced trip of the recall guard over both batches: the
    re-scored metrics and dumps equal a run whose feature stages take the
    full capped kernel."""
    from dgcnn_tpu_torch.eval.test import test
    from dgcnn_tpu_torch.train import steps as steps_mod
    from dgcnn_tpu_torch.train.__main__ import main as train_main
    from dgcnn_tpu_torch.utils.logging import IOStream

    rooms, root = os.path.join(tmp, "rooms"), os.path.join(tmp, "trained")
    kw = dict(num_points=N, num_features=4, test_batch_size=B, emb_dims=1024,
              model_root=root, validation_prop=0.8, seed=1, min_class_confidence=0.0)
    cli = ["--eval", "1", "--data_dir", rooms, "--k", str(K), "--num_points", str(N),
           "--num_features", "4", "--emb_dims", "1024", "--test_batch_size", str(B),
           "--validation_prop", "0.8", "--min_class_confidence", "0.0", "--model_root", root,
           "--test_visu_dir", os.path.join(tmp, "pred_cli"), "--device", "cuda"]
    cwd = os.getcwd()
    os.chdir(tmp)  # the CLI's log goes to ./checkpoints/<exp_name>/run.log
    try:
        t0 = time.perf_counter()
        rc = train_main(cli)
        cli_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    cli_log = open(os.path.join(tmp, "checkpoints", "dgcnn_tpu", "run.log")).read()
    io = IOStream(os.path.join(tmp, "eval.log"), stream=sys.stderr)

    def dumps(pred_dir):
        names = sorted(f for f in os.listdir(pred_dir) if f.endswith("_pred_gt.txt"))
        return names, {f: np.loadtxt(os.path.join(pred_dir, f)) for f in names}

    gpu = test(K, io, data_dir=rooms, pred_dir=os.path.join(tmp, "pred_gpu"), device="cuda",
               **kw)
    names, gpu_dumps = dumps(os.path.join(tmp, "pred_gpu"))
    cli_names, cli_dumps = dumps(os.path.join(tmp, "pred_cli"))
    n_true = len([f for f in os.listdir(os.path.join(tmp, "pred_cli"))
                  if f.endswith("_true_labels.txt")])
    if rc != 0 or len(names) != 16 or cli_names != names or n_true != 16 \
            or f"test acc: {gpu['accuracy']:.6f}" not in cli_log:
        raise AssertionError(f"[eval] --eval 1: rc {rc}, dumps {cli_names} / {names}, "
                             f"{n_true} true-label files")
    if any(not np.array_equal(cli_dumps[f], gpu_dumps[f]) for f in names):
        raise AssertionError("[eval] the CLI's dumps differ from test()'s")
    t0 = time.perf_counter()
    cpu = test(K, io, data_dir=rooms, pred_dir=os.path.join(tmp, "pred_cpu"), device="cpu",
               knn_impl="pallas_capped", **kw)  # on the CPU "auto" is the exact kNN
    cpu_s = time.perf_counter() - t0
    _, cpu_dumps = dumps(os.path.join(tmp, "pred_cpu"))
    points = sum(len(d) for d in gpu_dumps.values())
    differ = sum(int((gpu_dumps[f][:, 3] != cpu_dumps[f][:, 3]).sum()) for f in names)
    cm_moved = float(np.abs(gpu["confusion"] - cpu["confusion"]).sum() / 2)
    log(f"[eval] --eval 1 on the card ({cli_s:.2f} s): {points} points in {len(names)} rooms, "
        f"acc {gpu['accuracy']:.6f}, balanced acc {gpu['balanced_accuracy']:.6f}, mean IoU "
        f"{gpu['mean_iou']:.6f}, band_repaired {gpu['band_repaired']}; CPU plain "
        f"({cpu_s:.2f} s): acc {cpu['accuracy']:.6f}, balanced acc "
        f"{cpu['balanced_accuracy']:.6f}, mean IoU {cpu['mean_iou']:.6f}; {differ} points "
        f"predicted differently, {cm_moved:.0f} moved in the confusion matrix")
    if points != gpu["confusion"].sum() or differ > 0.0005 * points \
            or cm_moved > 0.0005 * points:
        raise AssertionError(f"[eval] card vs CPU: {differ} of {points} points differ")

    # the forced trip: both batches suspect, re-scored with the capped kNN
    forced = {"arm": True}
    real = steps_mod.BandGuardScheduler.suspect_dispatches

    def suspects(self):
        return [0, 1] if forced.pop("arm", None) else []

    steps_mod.BandGuardScheduler.suspect_dispatches = suspects
    try:
        fixed = test(K, io, data_dir=rooms, pred_dir=os.path.join(tmp, "pred_fix"),
                     device="cuda", **kw)
    finally:
        steps_mod.BandGuardScheduler.suspect_dispatches = real
    full = test(K, io, data_dir=rooms, pred_dir=os.path.join(tmp, "pred_full"),
                device="cuda", knn_band_feature=0, **kw)
    _, fix_dumps = dumps(os.path.join(tmp, "pred_fix"))
    _, full_dumps = dumps(os.path.join(tmp, "pred_full"))
    if forced or fixed["band_repaired"] != 2 \
            or not np.array_equal(fixed["confusion"], full["confusion"]) \
            or any(not np.array_equal(fix_dumps[f], full_dumps[f]) for f in names):
        raise AssertionError(f"[eval] forced trip: repaired {fixed['band_repaired']}, "
                             "metrics or dumps unlike the full capped kernel's")
    log(f"[eval] forced guard trip over 2 batches: re-scored, equal to the full capped "
        f"kernel's run (acc {full['accuracy']:.6f}; unrepaired {gpu['accuracy']:.6f})")

    # --eval 1 --compute_dtype bfloat16 through the port's command line, on
    # the same checkpoint and rooms: the bf16 stage kernel, no FP32 stage
    from dgcnn_tpu_torch.__main__ import run as port_cli

    bf16_cli = ["--mode", "classifier", "--compute_dtype", "bfloat16", *cli[:-4],
                "--test_visu_dir", os.path.join(tmp, "pred_bf16"), "--device", "cuda"]
    counters = reset_counters()
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        bf16 = port_cli(bf16_cli)
        bf16_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    launches = {name: fn.launches for name, fn in counters.items()}
    _, bf16_dumps = dumps(os.path.join(tmp, "pred_bf16"))
    bf16_differ = sum(int((gpu_dumps[f][:, 3] != bf16_dumps[f][:, 3]).sum()) for f in names)
    log(f"[eval] --eval 1 --compute_dtype bfloat16 ({bf16_s:.2f} s): acc "
        f"{bf16['accuracy']:.6f}, balanced acc {bf16['balanced_accuracy']:.6f}, mean IoU "
        f"{bf16['mean_iou']:.6f} (FP32: {gpu['mean_iou']:.6f}); {bf16_differ} of {points} "
        f"points predicted unlike FP32; launches {launches}")
    if (launches["edgeconv_fused_stage_bf16"] < 4 or launches["edgeconv_fused_stage"] != 0
            or sorted(bf16_dumps) != names or not np.isfinite(bf16["mean_iou"])):
        raise AssertionError(f"[eval] bf16: launches {launches}, dumps {sorted(bf16_dumps)}")
    return {"bf16_mean_iou": bf16["mean_iou"], "bf16_accuracy": bf16["accuracy"],
            "bf16_points_unlike_f32": bf16_differ, "bf16_cli_s": bf16_s,
            "bf16_launches": launches,"points": points, "accuracy": gpu["accuracy"],
            "balanced_accuracy": gpu["balanced_accuracy"], "mean_iou": gpu["mean_iou"],
            "cpu_accuracy": cpu["accuracy"], "points_unlike_cpu": differ,
            "confusion_moved_vs_cpu": cm_moved, "cli_s": cli_s, "cpu_s": cpu_s,
            "forced_trip_repaired": fixed["band_repaired"]}


def phase_lifecycle(tmp: str, smi: str) -> dict:
    """Phase 9: the offline lifecycle through the port's command line
    (``dgcnn_tpu_torch.__main__.run``, in-process, ``--device cuda`` by
    default) at full width, the launch counters reset before and read
    after: ``--mode process_data`` on a 110 m ``make_scene`` tile (544 500
    points; at least 16 rooms of 7000 points), 2 epochs of ``--eval 0``,
    ``--eval 1`` with its dumps, the post-processing (``export_dir`` on the
    CLI's dumps; ``process_dir``, ``combine_dirs`` and
    ``evaluate_combined_dir`` on ``test(dump_logits=True)``'s), ``--predict``
    on the tile, ``--predict`` on a directory of two 60 m tiles with
    ``--classify_all 1`` (every loaded point in its output), and the
    environment report. Each stage's time is printed."""
    import torch

    from dgcnn_tpu_torch.__main__ import run
    from dgcnn_tpu_torch.eval.predict import predict_load
    from dgcnn_tpu_torch.eval.test import test
    from dgcnn_tpu_torch.io.las import read_las, write_las
    from dgcnn_tpu_torch.postprocess import (
        combine_dirs, evaluate_combined_dir, export_dir, process_dir)
    from dgcnn_tpu_torch.prepare.dtm import _native_binary, _native_lib
    from dgcnn_tpu_torch.utils.logging import IOStream
    from dgcnn_tpu_torch.utils.report import collect_report
    from scripts.torch_full_pipeline import make_scene, process_data_argv

    root = os.path.join(tmp, "lifecycle")
    raw, npy, ckpt = (os.path.join(root, d) for d in ("raw", "npy", "ckpt"))
    landing = os.path.join(root, "landing")
    os.makedirs(raw)
    os.makedirs(landing)
    times = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        log(f"[lifecycle] {name}: {times[name]:.2f} s")
        return out

    tile = os.path.join(raw, "tile.las")
    x, y, z, cls = make_scene(np.random.default_rng(7), extent=110.0)
    write_las(tile, x, y, z, cls)
    for i in range(2):
        write_las(os.path.join(landing, f"tile{i}.las"),
                  *make_scene(np.random.default_rng(8 + i), extent=60.0))
    dtm = ("native library" if _native_lib() is not None else
           "native binary" if _native_binary() is not None else "Python (numpy)")
    model = ["--num_points", str(N), "--num_classes", "3", "--num_features", "4",
             "--k", str(K), "--emb_dims", "1024", "--model_root", ckpt,
             "--exp_name", "lifecycle"]
    data = ["--data_dir", npy, "--validation_prop", "0.2"]
    cwd = os.getcwd()
    os.chdir(root)  # the CLI's log: ./checkpoints/lifecycle/run.log
    counters = reset_counters()
    try:
        stage("process_data", lambda: run(process_data_argv(raw, root, npy)))
        rooms = len([f for f in os.listdir(npy) if f.endswith(".npy")])
        log(f"[lifecycle] process_data: {len(x)} points -> {rooms} rooms, DTM by the {dtm}")
        summary = stage("train", lambda: run(
            ["--mode", "classifier", "--eval", "0", *model, *data, "--epochs", "2",
             "--batch_size", str(B), "--validation_batch_size", str(B),
             "--tb_dir", os.path.join(root, "tb")]))
        metrics = stage("eval", lambda: run(
            ["--mode", "classifier", "--eval", "1", *model, *data, "--test_batch_size",
             str(B), "--min_class_confidence", "0.0", "--test_visu_dir",
             os.path.join(root, "dumps")]))

        def post():
            io = IOStream(os.path.join(root, "post.log"), stream=sys.stderr)
            test(K, io, data_dir=npy, num_points=N, num_classes=3, test_batch_size=B,
                 emb_dims=1024, model_root=ckpt, min_class_confidence=0.0,
                 pred_dir=os.path.join(root, "logits"), dump_logits=True, device="cuda")
            return {
                "las": export_dir(os.path.join(root, "dumps"), os.path.join(root, "las")),
                "prob": process_dir(os.path.join(root, "logits"), os.path.join(root, "prob")),
                "combined": combine_dirs(os.path.join(root, "logits"),
                                         os.path.join(root, "logits"),
                                         os.path.join(root, "combined")),
                "metrics": evaluate_combined_dir(os.path.join(root, "combined"), 3)}

        written = stage("postprocess", post)
        one = stage("predict", lambda: run(
            ["--mode", "classifier", "--predict", tile, "--predict_out",
             os.path.join(root, "classified.las"), *model, "--min_class_confidence", "0.0"]))
        many = stage("predict_dir", lambda: run(
            ["--mode", "classifier", "--predict", landing, "--predict_out",
             os.path.join(root, "classified"), "--classify_all", "1", *model]))
        report = stage("report", collect_report)
    finally:
        os.chdir(cwd)
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"[lifecycle] launches {launches}")
    log(f"[lifecycle] train {summary}; eval acc {metrics['accuracy']:.6f}, balanced acc "
        f"{metrics['balanced_accuracy']:.6f}, mean IoU {metrics['mean_iou']:.6f}; "
        f"combined dumps {written['metrics']['rooms']} rooms, acc "
        f"{written['metrics']['accuracy']:.6f}")
    log(f"[lifecycle] report: {json.dumps(report, default=str)}")

    if rooms < 16:
        raise AssertionError(f"[lifecycle] process_data wrote {rooms} rooms, fewer than 16")
    if not os.path.exists(os.path.join(ckpt, "dgcnn_model.npz")) \
            or not summary["best_balanced_accuracy"] > 0:
        raise AssertionError(f"[lifecycle] no checkpoint ({summary})")
    finite = [metrics[k_] for k_ in ("accuracy", "balanced_accuracy", "mean_iou")] + [
        written["metrics"][k_] for k_ in ("accuracy", "balanced_accuracy", "mean_iou")]
    if not np.isfinite(finite).all():
        raise AssertionError(f"[lifecycle] metrics {finite}")
    n_dumps = len([f for f in os.listdir(os.path.join(root, "dumps"))
                   if f.endswith("_pred_gt.txt")])
    if not n_dumps or len(written["las"]) != n_dumps or len(written["prob"]) != n_dumps \
            or len(written["combined"]) != n_dumps:
        raise AssertionError(f"[lifecycle] {n_dumps} dumps, post-processing wrote "
                             f"{ {k_: len(v) for k_, v in written.items() if k_ != 'metrics'} }")
    if not len(read_las(one[0])) or len(read_las(one[0])) % N:
        raise AssertionError(f"[lifecycle] --predict wrote {len(read_las(one[0]))} points")
    if [os.path.basename(p) for p in many] != ["tile0_classified.las", "tile1_classified.las"]:
        raise AssertionError(f"[lifecycle] --predict on a directory wrote {many}")
    for i, path in enumerate(many):
        # every loaded point, once per window it falls in (a point on a
        # window edge is classified in both)
        loaded = predict_load(os.path.join(landing, f"tile{i}.las"))[0][:, :3]
        out = read_las(path).xyz
        if not np.array_equal(*(np.unique(np.round(a * 1000).astype(np.int64), axis=0)
                                for a in (out, loaded))):  # at the LAS writer's 1 mm
            raise AssertionError(f"[lifecycle] {path}: {len(out)} points, {len(loaded)} loaded")
    if report.get("device_name") != torch.cuda.get_device_name(0) \
            or report.get("nvidia_smi") != smi or not report["kernels"]["built"]:
        raise AssertionError(f"[lifecycle] report {report}")
    need = ("knn_banded", "edgeconv_fused_stage", "edgeconv_fused_extrema", "gather_rows",
            "scatter_add_rows", "scatter_stage_tail_rows")
    if any(launches[k_] == 0 for k_ in need):
        raise AssertionError(f"[lifecycle] kernels not launched: {launches}")
    return {"rooms": rooms, "dtm": dtm, "seconds": times, "launches": launches,
            "train": summary, "eval": {k_: metrics[k_] for k_ in
                                       ("accuracy", "balanced_accuracy", "mean_iou")},
            "combined": written["metrics"]["accuracy"]}


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    knn_res, fused, scatter, gather, split = phase_kernels()
    split_launches = path_split()
    phase_wrappers()
    parity_wrapper = phase_parity_wrappers()
    with tempfile.TemporaryDirectory() as tmp:
        capped_launches, launches, mode_launches = phase_serve(tmp)
    phase_no_sync()
    fwd_ms, diffs = phase_forward()
    with tempfile.TemporaryDirectory() as tmp:
        trained = phase_train(tmp)
        evaluated = phase_eval(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        lifecycle = phase_lifecycle(tmp, smi)
    import torch

    def pick(cases, label):
        return next(r for r in cases if r["case"] == label)

    # bounds of the timed cases (B=8, N=7000, k=30): a kNN scores every
    # candidate row with a C-long FP32 dot (2 operations per channel); the
    # stage kernel multiplies each gathered row by the 64x64 W2; the
    # extrema kernel only gathers and compares
    bnc4 = 4.0 * B * N
    rows = [
        ("knn_capped", "knn_capped.cu", "knn_pallas.py:259", knn_res["knn_capped"],
         pick(knn_res["knn_capped"], "knn_capped float C=64"), capped_bound(64)),
        ("edgeconv_fused_stage", "edgeconv_fused.cu", "edgeconv_pallas.py:67", [fused[0]],
         fused[0], bound(bnc4 * (3 * 64 + K) + 4.0 * (64 * 64 + 4 * 64),
                         2.0 * B * N * K * 64 * 64)),
        # the stage's bf16_mm mode: the same rows, bf16 products on the
        # tensor cores
        ("edgeconv_fused_stage_bf16", "edgeconv_fused.cu", "edgeconv_pallas.py:67",
         [fused[2]], fused[2], bound(bnc4 * (3 * 64 + K) + 4.0 * (64 * 64 + 4 * 64),
                                     2.0 * B * N * K * 64 * 64, BF16_FLOP_PER_S)),
        ("edgeconv_fused_extrema", "edgeconv_fused.cu", "edgeconv_pallas.py:163",
         [fused[1]], fused[1], bound(bnc4 * (3 * 64 + K) + 4.0 * 3 * 64,
                                     2.0 * B * N * K * 64)),
        ("knn_banded", "knn_banded.cu", "knn_pallas.py:405", knn_res["knn_banded"],
         pick(knn_res["knn_banded"], "knn_banded float C=64 band 4096"),
         banded_bound(64, 4096, 384)),
        ("knn_exact", "knn_exact.cu", "knn_pallas.py:770", knn_res["knn_exact"],
         pick(knn_res["knn_exact"], "knn_exact int C=4, 256 queries"),
         bound(bnc4 * 4 + 4.0 * B * 256 * (4 + K), 2.0 * B * 256 * N * 4)),
        # the parity mode's stages 2-3: every query against all N rows (the
        # kernel scores no padding row); out: the indices, the k-th key and
        # the overflow flag
        ("knn_exact_banded", "knn_exact_banded.cu", "knn_pallas.py:566",
         knn_res["knn_exact_banded"],
         pick(knn_res["knn_exact_banded"], "knn_exact_banded float C=64 band 7040"),
         bound(bnc4 * (64 + 1 + K + 2), 2.0 * B * N * N * 64)),
        ("knn_packed", "knn_packed.cu", "knn_pallas.py:699", knn_res["knn_packed"],
         pick(knn_res["knn_packed"], "knn_packed float C=64"),
         bound(bnc4 * (64 + 1 + 1 + K), 2.0 * B * N * N * 64)),
    ]
    # the C=4 cases' bounds, for the kernel table. A banded kNN scores, per
    # query, the rows of its tile's band below N: stage 1's exact banded
    # kNN at query tile 256, the default path's banded kNN at 512, both at
    # band 2048. The capped kNN scores all N candidates per query (padding
    # rows score -inf without a dot); the flat exact kNN's self-kNN runs
    # at N=40 000, B=1
    n_big = 40000
    c4_bounds = {
        "knn_capped C=4": capped_bound(4),
        "knn_banded C=4 band 2048": banded_bound(4, 2048, 512),
        "knn_exact C=4 self N=40000": bound(4.0 * n_big * (4 + K), 2.0 * n_big * n_big * 4),
        "knn_exact_banded C=4 band 2048": bound(bnc4 * (4 + 1 + K + 2),
                                                2.0 * B * band_pairs(2048, 256) * 4),
        "knn_packed C=4": bound(bnc4 * (4 + 1 + 1 + K), 2.0 * B * N * N * 4),
    }
    # each kernel's launches on the path that runs it: the default serving
    # path for the first five, the parity and packed serving runs for the
    # two that carry those modes
    served = {**launches, "knn_exact_banded": mode_launches["parity"]["knn_exact_banded"],
              "knn_packed": mode_launches["packed"]["knn_packed"],
              "edgeconv_fused_stage_bf16":
                  mode_launches["bf16"]["edgeconv_fused_stage_bf16"]}
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"dgcnn_tpu_torch/kernels/csrc/{src}",
        "replaces": f"dgcnn_tpu/kernels/{tpu}", "launches": served[name],
        "max_abs_err": max(r["max_abs_err"] for r in cases),
        "ms": timed["ms"], "plain_ms": timed["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    } for name, src, tpu, cases, timed, (b_ms, b_by) in rows]
    timing = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the extrema kernel on the default forward's stage-3 indices, and its
    # second bound: the gathered rows at the measured L2 read rate
    ex_row = next(r for r in kernels if r["name"] == "edgeconv_fused_extrema")
    l2 = fused[1]["l2_gather"]
    ex_row["l2_bound_ms"] = l2["ms"]
    ex_row["l2_bytes_per_s"] = l2["bytes_per_s"]
    stage3 = pick(fused[1]["cases"], "stage 3 (the default forward's indices)")
    ex_row["stage3_forward"] = {
        "ms": stage3["ms"], "plain_ms": fused[1]["plain_ms"], "bound_ms": ex_row["bound_ms"],
        "bound_by": ex_row["bound_by"], "l2_bound_ms": l2["ms"], "library_ms": None}
    # the bf16 stage: the FP32 kernel's time in this run, cuBLAS's bare
    # product as a ceiling, the gather's L2 bound, the forward's stage-3 case
    bf_row = next(r for r in kernels if r["name"] == "edgeconv_fused_stage_bf16")
    bf_nbytes = bnc4 * (3 * 64 + K) + 4.0 * (64 * 64 + 4 * 64)
    bf_row.update({"mode": "bf16_mm", "status": "redesigned (ROADMAP R13)",
                   "geometry": fused[2]["geometry"], "f32_ms": fused[2]["f32_ms"],
                   "extrema_ms": fused[1]["ms"],
                   "bounds_ms": {"bytes": bf_nbytes / HBM_BYTES_PER_S * 1e3,
                                 "operations": 2.0 * B * N * K * 64 * 64 / BF16_FLOP_PER_S * 1e3,
                                 "l2_gather": l2["ms"]},
                   "cublas_bf16_ms": fused[2]["cublas_bf16_ms"],
                   "cublas_f32_ms": fused[2]["cublas_f32_ms"],
                   "stage3_forward_ms": pick(fused[2]["cases"],
                                             "stage 3 (the default forward's indices)")["ms"]})
    # the flat exact kNN at the repair's own call in the default forward
    rep = pick(knn_res["knn_exact"], "knn_exact repair (make_blocks, the forward's 256 queries)")
    b_ms, b_by = bound(bnc4 * 5 + 4.0 * B * 256 * (4 + K), 2.0 * B * 256 * N * 4)
    next(r for r in kernels if r["name"] == "knn_exact")["repair"] = {
        "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "failing_queries_per_cloud": rep["failing_queries_per_cloud"]}
    # the banded kNN's C=4 width (stage 1), beside its C=64 one
    c4 = pick(knn_res["knn_banded"], "knn_banded float C=4 band 2048")
    next(r for r in kernels if r["name"] == "knn_banded")["c4"] = {
        "ms": c4["ms"], "plain_ms": c4["plain_ms"],
        "bound_ms": c4_bounds["knn_banded C=4 band 2048"][0],
        "bound_by": c4_bounds["knn_banded C=4 band 2048"][1], "library_ms": None}

    # the parity and packed modes' stage 1 (C=4), beside their C=64 stages
    for name, label, key in (
            ("knn_exact_banded", "knn_exact_banded float C=4 band 2048",
             "knn_exact_banded C=4 band 2048"),
            ("knn_packed", "knn_packed float C=4 (blocks)", "knn_packed C=4")):
        c4 = pick(knn_res[name], label)
        next(r for r in kernels if r["name"] == name)["c4"] = {
            "ms": c4["ms"], "plain_ms": c4["plain_ms"], "bound_ms": c4_bounds[key][0],
            "bound_by": c4_bounds[key][1], "library_ms": None}

    # the capped kNN's C=4 self-kNN (the capped-only path's stage 1) and the
    # recall guard's probes, beside its C=64 self-kNN
    capped_row = next(r for r in kernels if r["name"] == "knn_capped")
    c4 = pick(knn_res["knn_capped"], "knn_capped float C=4 (blocks)")
    capped_row["c4"] = {"ms": c4["ms"], "plain_ms": c4["plain_ms"],
                        "bound_ms": c4_bounds["knn_capped C=4"][0],
                        "bound_by": c4_bounds["knn_capped C=4"][1], "library_ms": None}
    for m in PROBES:
        timed = pick(knn_res["knn_capped"], f"knn_capped float C=64 probes M={m}")
        b_ms, b_by = capped_bound(64, m)
        capped_row[f"probes_m{m}"] = {"ms": timed["ms"], "plain_ms": timed["plain_ms"],
                                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    def c4_case(cases):  # the row kernels' C=4 width beside the C=64 one
        return {"c4": {k_: pick(cases, "C=4 kNN of blocks")[k_] for k_ in timing}}

    # the tail kernel on the train step's own stage-3 inputs, beside it the
    # kNN-of-blocks case and the card's global reduction rate
    for name, tpu, case in (
            ("scatter_add_rows", "scatter_pallas.py:25", "C=64 kNN of blocks"),
            ("scatter_stage_tail_rows", "scatter_pallas.py:78",
             "C=64 stage 3 (the train step's own inputs)")):
        timed = pick(scatter[name], case)
        extra = c4_case(scatter[name]) if name == "scatter_add_rows" else {
            "knn_of_blocks": {k_: pick(scatter[name], "C=64 kNN of blocks")[k_]
                              for k_ in timing},
            "global_reduction_rate": scatter["global_reduction_rate"]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dgcnn_tpu_torch/kernels/csrc/scatter_rows.cu",
            "replaces": f"dgcnn_tpu/kernels/{tpu}",
            "launches": trained["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in scatter[name]),
            **{k_: timed[k_] for k_ in timing}, **extra})
    # the gather kernel on the train path (its launches in phase 7's
    # train() run, 3 per step); the split kNN on
    # Path B, knn_packed(..., splits=s), at C=64 with 8 splits (the same
    # work, so the same bound, as the flat packed kernel)
    timed = pick(gather, "C=64 kNN of blocks")
    kernels.append({
        "name": "gather_rows", "route": "cuda",
        "source": "dgcnn_tpu_torch/kernels/csrc/gather_rows.cu",
        "replaces": "dgcnn_tpu/kernels/gather_pallas.py:53",
        "launches": trained["launches"]["gather_rows"], "max_abs_err": 0.0,
        **{k_: timed[k_] for k_ in timing}, **c4_case(gather)})
    timed = pick(split, "float C=64 self splits 8")
    b_ms, b_by = bound(bnc4 * (64 + 1 + 1 + K), 2.0 * B * N * N * 64)
    kernels.append({
        "name": "knn_packed_split", "route": "cuda",
        "source": "dgcnn_tpu_torch/kernels/csrc/knn_packed.cu",
        "replaces": "dgcnn_tpu/kernels/knn_pallas.py:195",
        "launches": split_launches["knn_packed_split"],
        "max_abs_err": max(r["max_abs_err"] for r in split),
        "ms": timed["ms"], "plain_ms": timed["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "flat_ms": timed["flat_ms"]})
    for row in kernels:  # the share of its bound each kernel (and case) reaches
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["lifecycle_launches"] = lifecycle["launches"][row["name"]]
        for case in row.values():
            if isinstance(case, dict) and "bound_ms" in case:
                case["bound_share"] = case["bound_ms"] / case["ms"]
    log(json.dumps({"knn_cases": knn_res, "fused_cases": fused, "scatter_cases": scatter,
                    "gather_cases": gather,
                    "split_cases": split, "eval": evaluated,
                    "c4_bounds_ms": c4_bounds,
                    "forward_ms_per_batch": fwd_ms, "forward_prob_diff": diffs,
                    "capped_path_launches": capped_launches,
                    "mode_launches": mode_launches, "parity_wrapper": parity_wrapper,
                    "train": trained, "lifecycle": lifecycle}))
    log(json.dumps({"kernels": kernels}))
    from dgcnn_tpu_torch.ops.matmul import ROUTES

    log(f"bf16 trunk GEMM route: {ROUTES}; chip_smoke.py ran in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
