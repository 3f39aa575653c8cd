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
   ``lifecycle_launches``);
10. wide features (``num_features`` 6 and 9; the stage-1 kNN kernels at
   widths 8 and 16) on a 110 m ``make_scene`` tile written with raw
   intensity, returns and RGB (``scripts/torch_full_pipeline.py::
   write_wide_scene``, ``params/features_wide.json``): (a) the capped,
   banded, flat exact, exact banded, packed and split packed kNN kernels
   and the training gather at C=6 and C=9 against their plain versions at
   B=8, N=7000, k=30, bit for bit on integers in [0, 16), with their index
   agreement on the scene's floats and their times (each row of the
   kernels' line carries them as ``"c6"`` / ``"c9"``); (c) the lifecycle
   through the port's command line at F=6 (process_data, 2 epochs at full
   width, ``--eval 1``, ``--predict`` with ``--features_output``) and F=9
   (all but ``--eval 1``), the launch counters reset before and read after
   (``wide_lifecycle_launches`` in each row); (b) the default, parity and
   packed forwards at F = 4, 6 and 9 on the scene's blocks with the
   trained checkpoints, launch counts asserted, probabilities against the
   CPU plain forward with the card's kNN replayed, stage 1's route (the
   queries failing the band certificate, the repaired ones, the batches
   on the capped kNN) and the forward's synced and busy times, FP32 and
   bf16; (d) ``viz/features.py``'s depth taps on the card against the CPU
   plain forward, and ``--mode visualize``, which without scikit-learn or
   matplotlib must fail before loading anything, naming the package;
11. the trainer's configurations (run after phase 8, on phase 7's rooms,
   fixed batch and checkpoint): (a) ``remat`` off, selective and full, in
   FP32 and in bf16, 10 steps each at B=8, N=7000, k=30, emb 1024 on the
   default path with its amortized guard: the median step time of steps
   6-10 (host clock, one loss read a step), the device busy time of 3
   queued unguarded steps (``torch.profiler``), the peak memory, the
   launches per step of every kernel row (asserted: the gathers again in a
   recomputed region, twice again under full, where the banded kNN runs
   again too; one row and one
   tail scatter, neither stage kernel; each row of the kernels' line
   carries them as ``train_configs_launches_per_step``); (b) off and
   selective at B=32 (four of phase 7's batches); (c) one batch's
   gradients under selective and full against off, with a second off run
   for the atomics' spread (``REMAT_CARD_REL``), the running statistics
   equal; the bf16 step against the CPU plain bf16 step at (2, 2048), the
   CPU replaying the card's kNN: its loss within a quarter, its worst leaf
   within half of the distance from the CPU's bf16 step to its FP32 step,
   beside the card's GEMMs' mean error against float64 (``gemm_bias``);
   every configuration's training forward and backward under
   ``set_sync_debug_mode("error")``; (d) ``--compute_dtype bfloat16
   --remat selective`` through the CLI for 2 epochs, then ``--eval 1`` in
   bf16 on its checkpoint; (e) phase 7's checkpoint rewritten as the
   sharded directory (``save_checkpoint_sharded``): ``predict()`` and
   ``test()`` from it give the file's labels and confusion matrix, and
   ``train()`` resumes from it. The phase prints its own time.

12. the parallel paths (run after phase 11, in one process: NCCL refuses
   two ranks on one card, so one rank holds all four point shards):
   (a) the ring kNN (``parallel/ring_knn.py``) of phase 4's 120 m x 60 m
   tile as one x-sorted cloud over 4 shards, stage 1's C=4 input on the
   full and the certified banded ring (its in-band flag printed) and a
   C=64 feature cloud on the full ring: ``knn_exact``'s launches per ring
   asserted, each ring bit for bit equal to the ring whose hops run the
   plain version and its k best scores equal to the flat exact kNN's on
   integer-valued copies, its neighbour sets equal to the flat exact
   kNN's on the floats, one hop's kernel call held against its plain
   version at N_l = 17 500 and timed, and the ring gather's row kernels
   at the ring's shapes; (b) the whole tile through ``predict(point_shards
   =4)``, the CLI's ``--predict --point_shards 4`` and the serve CLI (the
   same labels; ``knn_exact`` and ``gather_rows`` launches asserted), its
   probabilities within 1e-3 of the unsharded parity forward of the same
   cloud (B=1, N=70 000), the whole-tile forward's time beside the default
   path's forward of the tile's blocks; (c) point-sharded training at B=2,
   N=28 000, k=30, emb 1024: one step's loss within 1e-5 and gradients
   within 1e-2 of the unsharded parity step replaying the ring's graph,
   one ``scatter_add_rows`` per gather hop, the step time and peak memory;
   (d) ``--num_processes 1 --coordinator_address 127.0.0.1:<port>``
   through the CLI (a process group over NCCL) for 1 epoch on phase 7's
   rooms, the checkpoint restored by ``eval/test.py`` and a tile served
   from it; (e) the tensor-parallel trunk over 2 shards within 1e-5 of the
   replicated one, ``tp_shard_info`` showing the halves. Each kernel row
   carries its launches there (``parallel_launches``); the phase prints
   its own time.

13. precision and dtypes (run after phase 12, on phase 7's rooms and
   checkpoint): (a) the TF32 stage kernel (``matmul_precision="default"``)
   against its plain version on every ``stage_cases`` case within
   ``stage_tf32_tolerance``, bit for bit on integer operands at the
   production shape, timed by ``cuda_ms_many`` beside the FP32 and bf16
   stage kernels and cuBLAS's TF32 GEMM on the bare product, with its
   share of each bound (TF32 operations, bytes, the gather's rows at phase
   2's L2 read rate) and its registers and spills (the build log); (b) the
   production forward under "default", "high", "highest", float16,
   "float32" and bf16 with "highest": each against the CPU plain forward of
   the same configuration (2, 2048) within 1e-3, against the FP32 forward
   (max probability difference, argmax agreement), its stage launches
   asserted, its synced time (CUDA events, median of 10, and
   ``utils/profiling.py::measure``), the non-finite values of its outputs;
   FP32 and bf16 timed beside them; under "default" every kNN call's
   indices equal the FP32 kNN's on the same features (the default path's,
   and the exact kNN's whose scores go through cuBLAS); (c) 10 train steps
   each under "default" and float16 on phase 7's fixed batch
   (``profiling.StepTimer``, median of steps 6-10; the peak; the loss
   falls), one step's gradients against the CPU plain versions on the
   card's graph; (d) one tile through the serve CLI with
   ``--matmul_precision default``, ``--eval 1 --compute_dtype float16`` on
   phase 7's checkpoint, one CLI epoch with ``--matmul_precision
   highest``. The phase prints its own time.

14. the approximate kNN (``knn_impl="approx"``, JAX's ``approx_max_k`` at
   recall 0.95, run after phase 10): the kernel against its plain version
   bit for bit on integer clouds (``APPROX_INT_CASES``: C=4 and C=64 at the
   production shape, L=896 with a short last chunk; L=N; N=2000, L=1024;
   k=16 and 64; 1000 ``queries=`` rows), the first design's SHA-256
   digests (``APPROX_DIGESTS``: ``make_blocks`` at C=4, normal C=64, 1000
   queries, a cloud with inf / nan coordinates), the kernel's registers
   and spills (the build log), at least 0.9999 index agreement on
   ``make_blocks``' floats, and on the approx forward's own three calls
   each call's device-only time, wrapper time, plain time, bound and recall
   against the exact kNN; the approx forward within 1e-3 of the CPU plain
   forward at (2, 5000); one forward's and one train step's launches at
   full width (3 approximate kNNs each); the approx forward's synced and
   busy times beside the default forward's; one tile served and the same
   tile through ``--predict --knn_impl approx``, launch counts asserted.
   The phase prints its own time.

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
    from dgcnn_tpu_torch.kernels.knn_approx import knn_approx
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
        edgeconv_fused_extrema, edgeconv_fused_stage, edgeconv_fused_stage_bf16,
        edgeconv_fused_stage_tf32)
    from dgcnn_tpu_torch.kernels.knn_approx import knn_approx
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
            "edgeconv_fused_stage_tf32": edgeconv_fused_stage_tf32,
            "edgeconv_fused_extrema": edgeconv_fused_extrema,
            "knn_banded": knn_banded_raw, "knn_exact": knn_exact,
            "knn_exact_banded": knn_exact_banded_raw, "knn_packed": knn_packed,
            "knn_packed_split": _knn_packed_split,
            "scatter_add_rows": scatter_add_rows,
            "scatter_stage_tail_rows": scatter_stage_tail_rows,
            "gather_rows": gather_rows, "knn_approx": knn_approx}


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
                     ("bf16", dict(compute_dtype="bfloat16")),
                     ("tf32", dict(matmul_precision="default"))):
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
        "forward and a parity-mode, a packed-mode, a bf16 and a TF32 default forward "
        "ran under set_sync_debug_mode('error')")


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


# the training configurations of phase 11: (compute_dtype, remat); per
# train step on the default path, (gather_rows, knn_banded): the stages'
# gathers run again in each recomputed stage region (selective), and under
# full twice again (the whole forward's recompute, then each stage's
# nested region), the kNN again under full; one row scatter and one tail
# scatter in every backward
TRAIN_CONFIGS = tuple((dt, mode) for dt in (None, "bfloat16")
                      for mode in ("off", "selective", "full"))
CONFIG_LAUNCHES = {"off": (3, 3), "selective": (6, 3), "full": (9, 6)}
# the scatters add with atomics, so two "off" backwards on the card differ
# in the last bits; a recompute reproduces the forward's values, so a
# remat mode's gradients lie as near "off"'s as a second "off" run does
REMAT_CARD_REL = 1e-4
# the bf16 step on the card against the CPU plain bf16 step on the card's
# graph: a bf16 step, not an FP32 one, when its loss lies within a quarter
# and its worst leaf within half of the distance from the CPU's bf16 step
# to the CPU's FP32 step. The bf16 step is ill-conditioned
# (tests/test_torch_bf16_train.py: JAX's own gradients move by up to 26% per
# leaf when its weights move by 2^-22), and the card's bf16 GEMMs sum on the
# tensor cores, whose mean error against float64 phase 11 measures beside
# the FP32 GEMM's (``gemm_bias``): on an H100 the card's bf16 loss sat
# further from the CPU's than scaling the weights by 1 +- 2^-21 moves the
# CPU step's own, so that spread is no bound for it (PERF.md)
BF16_LOSS_SHARE, BF16_LEAF_SHARE = 0.25, 0.5


def gemm_bias() -> dict:
    """The mean signed relative error (negative: toward zero) against
    float64 of the card's bf16 GEMM with an FP32 output (``torch.mm(...,
    out_dtype=torch.float32)``, the trunk's route) and of its FP32 GEMM,
    on the same bf16 operands at conv7's shape (B*N rows of emb + 192 =
    1216 channels against 512)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(7)
    a = torch.randn(B * N, 1216, device="cuda", generator=g).bfloat16()
    b = (torch.randn(1216, 512, device="cuda", generator=g) / 35.0).bfloat16()
    exact = a.double() @ b.double()
    keep = exact.abs() > 1e-3
    out = {}
    for name, got in (("bf16_gemm", torch.mm(a, b, out_dtype=torch.float32)),
                      ("fp32_gemm", a.float() @ b.float())):
        rel = ((got.double() - exact) / exact)[keep]
        out[name] = {"mean_signed_rel": rel.mean().item(), "mean_abs_rel": rel.abs().mean().item()}
    return out


def _config_name(dtype, mode) -> str:
    return f"{dtype or 'fp32'} {mode}"


def _train_steps(cfg, remat, pts, labels, mask, n_steps: int) -> tuple:
    """``n_steps`` of the loop's step (the amortized guard's modes, one
    host read a step) on one batch from a fresh state: ``(state, step,
    losses, host ms per step, peak GB, launches per step)``."""
    import torch

    from dgcnn_tpu_torch.train.steps import (
        BandGuardScheduler, init_train_state, make_train_step)

    state = init_train_state(cfg, seed=2, device="cuda", epochs=30)
    sched = BandGuardScheduler(cfg, "cuda")
    step = make_train_step(cfg, band_guard=sched.active, remat=remat)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    losses, times = [], []
    for _ in range(n_steps):
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
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {name: fn.launches / n_steps for name, fn in counters.items()}
    return state, step, losses, times, peak, per_step


def _grads(model, x, labels, mask, remat="off"):
    from dgcnn_tpu_torch.ops.losses import masked_smoothed_cross_entropy

    model.zero_grad(set_to_none=True)
    loss = masked_smoothed_cross_entropy(model(x, remat=remat), labels, mask)
    loss.backward()
    return loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()}


def _worst_rel(got, want) -> tuple[str, float]:
    floor = 1e-3 * max(g.norm().item() for g in want.values())
    rels = {k: _rel(got[k], w, floor) for k, w in want.items()}
    worst = max(rels, key=rels.get)
    return worst, rels[worst]


def phase_train_configs(tmp: str) -> dict:
    """Phase 11: the trainer's remat and bf16 configurations at full width
    on phase 7's rooms and fixed batch (B=8, N=7000, k=30, emb 1024, the
    default ``auto`` path with its amortized guard), then the sharded
    checkpoint directory."""
    import torch

    from dgcnn_tpu_torch.__main__ import run as port_cli
    from dgcnn_tpu_torch.data.dataset import FugroDataset
    from dgcnn_tpu_torch.data.prefetch import to_device
    from dgcnn_tpu_torch.eval.predict import predict
    from dgcnn_tpu_torch.eval.test import test
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn
    from dgcnn_tpu_torch.ops.losses import masked_smoothed_cross_entropy
    from dgcnn_tpu_torch.train.checkpoint import save_checkpoint_sharded, try_resume
    from dgcnn_tpu_torch.train.loop import train
    from dgcnn_tpu_torch.train.steps import init_train_state
    from dgcnn_tpu_torch.utils.logging import IOStream
    from scripts.torch_profile_forward import profile

    t_phase = time.perf_counter()
    rooms, root = os.path.join(tmp, "rooms"), os.path.join(tmp, "trained")
    data = FugroDataset("train", rooms, num_point=N, seed=1)
    batch = next(data.batches(B, epoch=0))
    pts, labels, mask = to_device((batch.points, batch.labels, batch.mask), "cuda")

    # (a) the six configurations: 10 steps each, the host clock's median of
    # steps 6-10, the peak, the launches per step; device busy of 3 queued
    # unguarded steps (torch.profiler)
    configs = {}
    for dtype, remat in TRAIN_CONFIGS:
        cfg = DGCNNConfig(k=K, emb_dims=1024, compute_dtype=dtype)
        state, step, losses, times, peak, per_step = _train_steps(
            cfg, remat, pts, labels, mask, 10)
        prof = profile(lambda: float(step(state, pts, labels, mask, 0)["loss"]), 3, grad=True)
        name = _config_name(dtype, remat)
        configs[name] = {"step_ms": float(np.median(times[5:])), "step_ms_all": times,
                         "peak_gb": peak, "loss": losses[-1], "losses": losses,
                         "busy_ms": prof["busy_ms_per_forward"],
                         "idle_share": prof["idle_share"], "launches_per_step": per_step}
        log(f"[train configs] {name}: step {configs[name]['step_ms']:.3f} ms (median of steps "
            f"6-10), busy {prof['busy_ms_per_forward']:.3f} ms, peak {peak:.3f} GB, losses "
            f"{[round(v, 4) for v in losses]}; launches per step {per_step}")
        want = CONFIG_LAUNCHES[remat]
        if not all(np.isfinite(losses)) or (per_step["gather_rows"], per_step["knn_banded"]) \
                != want or per_step["scatter_add_rows"] != 1 \
                or per_step["scatter_stage_tail_rows"] != 1 \
                or per_step["edgeconv_fused_stage"] or per_step["edgeconv_fused_stage_bf16"] \
                or per_step["edgeconv_fused_extrema"]:
            raise AssertionError(f"[train configs] {name}: losses {losses}, launches "
                                 f"{per_step}, expected (gathers, banded kNNs) {want}")
        del state, step
    # (b) batch 32: four of phase 7's batches, "off" and "selective", FP32
    big = [b_ for e in range(2) for b_ in data.batches(B, epoch=e)][:4]
    pts32, labels32, mask32 = to_device(tuple(np.concatenate([getattr(b_, f) for b_ in big])
                                              for f in ("points", "labels", "mask")), "cuda")
    batch32 = {}
    for remat in ("off", "selective"):
        _, _, losses, times, peak, _ = _train_steps(DGCNNConfig(k=K, emb_dims=1024), remat,
                                                    pts32, labels32, mask32, 6)
        batch32[remat] = {"step_ms": float(np.median(times[3:])), "step_ms_all": times,
                          "peak_gb": peak, "losses": losses}
        log(f"[train configs] B=32 {remat}: step {batch32[remat]['step_ms']:.3f} ms (median "
            f"of steps 4-6), peak {peak:.3f} GB")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"[train configs] B=32 {remat}: losses {losses}")
    if not batch32["selective"]["peak_gb"] < batch32["off"]["peak_gb"]:
        raise AssertionError(f"[train configs] B=32: selective does not lower the peak {batch32}")

    # (c) gradients on one batch and one set of weights, dropout 0: each
    # remat mode against "off" (and "off" against itself: the atomics),
    # running statistics after the step; then no host sync in the
    # training forward and backward of any configuration
    gcfg = DGCNNConfig(k=K, emb_dims=1024, dropout=0.0)
    model = init_dgcnn(gcfg, torch.Generator().manual_seed(3), device="cuda").train()
    stats0 = {k_: v.clone() for k_, v in model.state_dict().items() if k_.startswith("bn")}
    runs = {}
    for remat in ("off", "off", "selective", "full"):
        model.load_state_dict({**model.state_dict(), **stats0})
        loss, grads = _grads(model, pts, labels, mask, remat)
        stats = {k_: v.clone() for k_, v in model.state_dict().items() if k_.startswith("bn")}
        runs.setdefault(remat, []).append((loss, grads, stats))
    off_loss, off, off_stats = runs["off"][0]
    noise = _worst_rel(runs["off"][1][1], off)
    remat_rel = {m: _worst_rel(runs[m][0][1], off) for m in ("selective", "full")}
    stats_equal = {m: all(torch.equal(runs[m][0][2][k_], v) for k_, v in off_stats.items())
                   for m in ("selective", "full")}
    log(f"[train configs] gradients (B=8, N=7000) against remat off: off again {noise}, "
        f"selective {remat_rel['selective']}, full {remat_rel['full']} (tolerance "
        f"{REMAT_CARD_REL}); running statistics equal: {stats_equal}")
    if noise[1] > REMAT_CARD_REL or any(r[1] > REMAT_CARD_REL for r in remat_rel.values()) \
            or not all(stats_equal.values()) \
            or any(runs[m][0][0] != off_loss for m in ("selective", "full")):
        raise AssertionError(f"[train configs] remat gradients {remat_rel}, noise {noise}, "
                             f"stats {stats_equal}")
    del model, runs
    # the bf16 step on the card against the CPU plain bf16 step at (2, 2048),
    # the CPU replaying the card's kNN
    bcfg = DGCNNConfig(k=K, emb_dims=1024, dropout=0.0, compute_dtype="bfloat16")
    weights = init_dgcnn(bcfg, torch.Generator().manual_seed(3)).state_dict()
    shape = (2, 2048)
    small = torch.from_numpy(make_blocks(*shape, seed=6))
    rng = np.random.default_rng(6)
    lab = torch.from_numpy(rng.integers(0, 5, shape))
    msk = torch.from_numpy((rng.random(shape) < 0.7).astype(np.float32))
    card = DGCNN(bcfg)
    card.load_state_dict(weights)
    card = card.to("cuda").train()
    graph = []

    def record(*args, **kwargs):
        graph.append(DGCNN._knn(card, *args, **kwargs))
        return graph[-1]

    card._knn = record
    bf_card = _grads(card, small.cuda(), lab.cuda(), msk.cuda())
    plain = DGCNN(dataclasses.replace(bcfg, knn_impl="pallas_capped"))
    plain.load_state_dict(weights)
    plain.train()
    queue = list(graph)
    plain._knn = lambda v, *a, **kw: queue.pop(0).to(v.device)
    bf_cpu = _grads(plain, small, lab, msk)
    f32 = DGCNN(dataclasses.replace(bcfg, knn_impl="pallas_capped", compute_dtype=None))
    f32.load_state_dict(weights)
    f32_loss, f32_grads = _grads(f32.train(), small, lab, msk)
    bf16_worst = _worst_rel(bf_card[1], bf_cpu[1])
    bf16_loss = abs(bf_card[0] - bf_cpu[0])
    f32_worst = _worst_rel(f32_grads, bf_cpu[1])
    f32_loss_gap = abs(f32_loss - bf_cpu[0])
    bias = gemm_bias()
    log(f"[train configs] bf16 step (2, 2048) GPU vs CPU plain on the card's graph: loss "
        f"{bf_card[0]:.7f} vs {bf_cpu[0]:.7f} (diff {bf16_loss:.2e}), worst leaf {bf16_worst}; "
        f"the CPU's FP32 step: loss {f32_loss:.7f} (diff {f32_loss_gap:.2e}), its gradients "
        f"against bf16's {f32_worst}; the card's GEMMs against float64 at conv7's shape: {bias}")
    if bf16_loss > BF16_LOSS_SHARE * f32_loss_gap \
            or bf16_worst[1] > BF16_LEAF_SHARE * f32_worst[1]:
        raise AssertionError(f"[train configs] bf16 GPU vs CPU: {bf16_worst}, {bf16_loss}; "
                             f"FP32 vs bf16 on the CPU: {f32_worst}, {f32_loss_gap}")
    for dtype, remat in TRAIN_CONFIGS:
        m = DGCNN(DGCNNConfig(k=K, emb_dims=1024, compute_dtype=dtype)).to("cuda").train()
        m.load_state_dict(weights)
        for band_mode in (1, 0):
            _grads(m, pts, labels, mask, remat)  # warm: the bf16 route's probe reads once
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                loss = masked_smoothed_cross_entropy(
                    m(pts, band_mode=band_mode, with_band_flag=True, remat=remat)[0],
                    labels, mask)
                loss.backward()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("[train configs] no host sync: the training forward and backward of all six "
        "configurations, guarded and unguarded, under set_sync_debug_mode('error')")

    # (d) bf16 training through the CLI: 2 epochs with --remat selective,
    # then --eval 1 in bf16 on its checkpoint
    bf16_root = os.path.join(tmp, "bf16_trained")
    model_args = ["--data_dir", rooms, "--k", str(K), "--num_points", str(N),
                  "--num_features", "4", "--emb_dims", "1024", "--model_root", bf16_root,
                  "--compute_dtype", "bfloat16", "--exp_name", "bf16", "--device", "cuda"]
    counters = reset_counters()
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        summary = port_cli(["--mode", "classifier", "--eval", "0", *model_args, "--remat",
                            "selective", "--epochs", "2", "--batch_size", str(B),
                            "--validation_batch_size", str(B), "--validation_prop", "0.2",
                            "--tb_dir", os.path.join(tmp, "tb_bf16")])
        cli_train_s = time.perf_counter() - t0
        train_launches = {name: fn.launches for name, fn in counters.items()}
        t0 = time.perf_counter()
        metrics = port_cli(["--mode", "classifier", "--eval", "1", *model_args,
                            "--test_batch_size", str(B), "--validation_prop", "0.8",
                            "--min_class_confidence", "0.0",
                            "--test_visu_dir", os.path.join(tmp, "pred_bf16_trained")])
        cli_eval_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    log(f"[train configs] CLI bf16 --remat selective, 2 epochs ({cli_train_s:.2f} s): "
        f"{summary}; --eval 1 bf16 ({cli_eval_s:.2f} s): acc {metrics['accuracy']:.6f}, "
        f"mean IoU {metrics['mean_iou']:.6f}; training launches {train_launches}")
    if not os.path.exists(os.path.join(bf16_root, "dgcnn_model.npz")) \
            or not np.isfinite([summary["best_balanced_accuracy"], metrics["mean_iou"]]).all() \
            or train_launches["edgeconv_fused_stage"] != 0:
        raise AssertionError(f"[train configs] CLI bf16: {summary}, {metrics}")

    # (e) phase 7's checkpoint rewritten as a sharded directory by the
    # port's writer: predict() and --eval 1 (test()) from it give the single
    # file's labels and metrics, and train() resumes from it
    io = IOStream(os.path.join(tmp, "sharded.log"), stream=sys.stderr)
    dcfg = DGCNNConfig(k=K, emb_dims=1024)
    state = init_train_state(dcfg, seed=0, device="cuda", epochs=2, steps_per_epoch=2)
    meta = try_resume(os.path.join(root, "dgcnn_model.npz"), state)
    dir_root = os.path.join(tmp, "sharded")
    save_checkpoint_sharded(os.path.join(dir_root, "dgcnn_model.npz"), state, **meta)
    tile = os.path.join(tmp, "sharded_tile.las")
    write_tile(tile, 302, (120.0, 60.0), 70000)
    got = {}
    for name, r in (("file", root), ("dir", dir_root)):
        _, labels_ = predict(K, io, tile, os.path.join(tmp, f"sharded_{name}.las"),
                             num_points=N, block_size=30.0, emb_dims=1024, model_root=r,
                             batch_size=B, device="cuda")
        m_ = test(K, io, data_dir=rooms, num_points=N, num_features=4, test_batch_size=B,
                  emb_dims=1024, model_root=r, validation_prop=0.8, seed=1,
                  min_class_confidence=0.0, pred_dir=os.path.join(tmp, f"sharded_pred_{name}"),
                  device="cuda")
        got[name] = (np.asarray(labels_), m_["confusion"])
    labels_equal = bool(np.array_equal(got["dir"][0], got["file"][0]))
    confusion_equal = bool(np.array_equal(got["dir"][1], got["file"][1]))
    resume_log = os.path.join(tmp, "sharded_train.log")
    resumed = train(K, IOStream(resume_log, stream=sys.stderr), data_dir=rooms, num_points=N,
                    epochs=int(meta["epoch"]) + 2, train_batch_size=B, validation_batch_size=B,
                    emb_dims=1024, model_root=dir_root, tb_dir=os.path.join(tmp, "tb_sh"),
                    seed=1, device="cuda")
    log_text = open(resume_log).read()
    log(f"[train configs] sharded directory (epoch {meta['epoch']}): predict() labels equal "
        f"the file's: {labels_equal} ({len(got['dir'][0])} points); test() confusion equal: "
        f"{confusion_equal}; train() resumed: {'Use pretrained model' in log_text}, {resumed}")
    if not (labels_equal and confusion_equal and "Use pretrained model" in log_text
            and resumed.get("epoch") == int(meta["epoch"]) + 1):
        raise AssertionError("[train configs] the sharded directory round trip failed")
    phase_s = time.perf_counter() - t_phase
    log(f"[train configs] phase 11 ran in {phase_s:.1f} s")
    return {"configs": configs, "batch32": batch32,
            "remat_grad_rel": {m: r[1] for m, r in remat_rel.items()},
            "off_noise_rel": noise[1], "running_stats_equal": stats_equal,
            "bf16_vs_cpu": {"worst_leaf": bf16_worst[0], "rel": bf16_worst[1],
                            "loss_diff": bf16_loss, "f32_loss_diff": f32_loss_gap,
                            "f32_grad_rel": f32_worst[1], "gemm_bias": bias},
            "cli_bf16": {"summary": summary, "mean_iou": metrics["mean_iou"],
                         "accuracy": metrics["accuracy"], "train_s": cli_train_s},
            "sharded": {"labels_equal": labels_equal, "confusion_equal": confusion_equal,
                        "resumed_epoch": resumed.get("epoch"), "points": len(got["dir"][0])},
            "phase_s": phase_s}


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


WIDE = (6, 9)  # the wide-feature widths: kNN kernel widths 8 and 16


def wide_scene(tmp: str) -> tuple[str, dict]:
    """The wide-feature scene (``scripts/torch_full_pipeline.py``:
    ``make_scene`` at 110 m, 544 500 points, with raw intensity, returns and
    RGB), written as one LAS tile; and its blocks as ``predict`` draws and
    assembles them (30 m windows of N points, x-sorted, shifted to their x /
    y minimum, AGL from the DTM), at F = 4 (x y z agl), 6 and 9 (the lists
    of ``WIDE_OUTPUTS`` through ``params/features_wide.json``)."""
    from dgcnn_tpu_torch.eval.predict import (
        _block_rows, assemble_batch, model_columns, predict_load)
    from dgcnn_tpu_torch.prepare.dtm import build_dtm, gen_agl
    from scripts.torch_full_pipeline import WIDE_FEATURES_FILE, WIDE_OUTPUTS, write_wide_scene

    tile = os.path.join(tmp, "wide", "raw", "tile.las")
    os.makedirs(os.path.dirname(tile))
    n = write_wide_scene(tile, np.random.default_rng(7), extent=110.0)
    with open(WIDE_FEATURES_FILE) as fh:
        features = json.load(fh)
    data, labels = predict_load(tile, features, WIDE_OUTPUTS[9])  # every field
    data[:, features["agl"]] = gen_agl(build_dtm(data[:, :3]), data[:, :3])
    rows, _ = _block_rows(data, labels, None, N, 30.0, np.random.default_rng(0), False)
    blocks = {f: assemble_batch(data, rows, model_columns(features, names, data.shape[1], f))
              for f, names in ((4, ["x", "y", "z", "agl"]), *WIDE_OUTPUTS.items())}
    log(f"[wide] scene: {n} points, {len(blocks[4])} blocks of {N}; columns of F=9 span "
        f"{np.abs(blocks[9]).max(axis=(0, 1)).round(1).tolist()}")
    return tile, blocks


def _wide_case(name, run, plain, x_int, x_float, outputs, bound_ms_by):
    """One stage-1 kernel at one wide width: bit for bit against its plain
    version on integers; on the scene's floats (not FP32-exact: squared
    norms of raw colours reach ~1e10) the share of index entries equal to
    the plain version's and whether every row holds k distinct valid rows;
    both timed on the scene's batch. ``outputs``: how many of the kernel's
    outputs are compared (the indices first)."""
    import torch

    def first(out):
        return tuple(out)[:outputs] if isinstance(out, tuple) else (out,)

    got, want = first(run(x_int)), first(plain(x_int))
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name}: kernel != plain on integers in [0, 16)")
    got, want = first(run(x_float))[0], first(plain(x_float))[0]
    torch.cuda.synchronize()
    srt = got.sort(-1).values
    if not ((srt[..., 1:] != srt[..., :-1]).all() and (got >= 0).all()
            and (got < x_float.shape[1]).all()):
        raise AssertionError(f"{name}: a row of the scene's indices repeats or leaves [0, N)")
    agree = (got == want).float().mean().item()
    ms = cuda_ms_many(lambda: run(x_float), 20, 10)
    plain_ms = cuda_ms(lambda: plain(x_float), 2)
    log(f"[wide] {name}: bit-equal on integers; scene floats: index agreement {agree:.6f}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms_by[0]:.4f} ms")
    return {"int_bit_equal": True, "scene_index_agreement": agree, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms_by[0],
            "bound_by": bound_ms_by[1], "library_ms": None}


def phase_wide_kernels(blocks: dict) -> dict:
    """Phase 10a: rows 1, 4, 5, 6, 7, 11 and 10 at C=6 and C=9 (kernel
    widths 8 and 16), B=8, N=7000, k=30, each against its plain version:
    the capped kNN (cap 8, the banded wrapper's fallback), the banded kNN
    (band 2048, tile 512, 64 windows, cap 6: indices and k-th keys), the
    flat exact kNN at the repair's shape (256 queries a cloud with their
    rows as the hint; at width 8 a 7000-row cloud misses shared memory, so
    the kernel's L1 / L2 branch runs), the exact banded kNN (the parity
    mode's stage 1: band 2048, tile 256, cap 8; its three outputs), the
    packed and split packed kNN, and the training gather of the points
    (bit for bit on the scene's floats too; ``torch.gather`` beside it)."""
    import torch

    from dgcnn_tpu_torch.kernels.gather_rows import gather_rows, gather_rows_plain
    from dgcnn_tpu_torch.kernels.knn_banded import knn_banded_raw, knn_banded_raw_plain
    from dgcnn_tpu_torch.kernels.knn_capped import knn_capped, knn_capped_plain
    from dgcnn_tpu_torch.kernels.knn_exact import cloud_fits, knn_exact, knn_exact_plain
    from dgcnn_tpu_torch.kernels.knn_exact_banded import (
        knn_exact_banded_raw, knn_exact_banded_raw_plain)
    from dgcnn_tpu_torch.kernels.knn_packed import (
        knn_packed, knn_packed_plain, knn_packed_split_plain)

    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    rows = torch.from_numpy(rng.permutation(N)[:256]).to(dev).expand(B, -1).contiguous()
    band = dict(band=2048, query_tile=512, **BANDS)
    eb = dict(band=2048, n_win=64, cap=8, query_tile=256)
    out = {}
    for c in WIDE:
        ints = rng.integers(0, 16, (B, N, c)).astype(np.float32)
        ints = np.take_along_axis(ints, np.argsort(ints[..., 0], 1, kind="stable")[..., None], 1)
        xi = torch.from_numpy(np.ascontiguousarray(ints)).to(dev)
        xf = torch.from_numpy(blocks[c][:B]).to(dev)
        bnc = 4.0 * B * N

        def q(x):
            return x.gather(1, rows[..., None].expand(-1, -1, c))

        cases = {
            "knn_capped": (lambda x: knn_capped(x, K, cap=8),
                           lambda x: knn_capped_plain(x, K, cap=8), 1, capped_bound(c)),
            "knn_banded": (lambda x: knn_banded_raw(x, K, **band),
                           lambda x: knn_banded_raw_plain(x, K, **band), 2,
                           banded_bound(c, 2048, 512)),
            "knn_exact": (lambda x: knn_exact(x, K, queries=q(x), query_rows=rows),
                          lambda x: knn_exact_plain(x, K, queries=q(x)), 1,
                          bound(bnc * c + 4.0 * B * 256 * (c + K), 2.0 * B * 256 * N * c)),
            "knn_exact_banded": (lambda x: knn_exact_banded_raw(x, K, **eb),
                                 lambda x: knn_exact_banded_raw_plain(x, K, **eb), 3,
                                 bound(bnc * (c + 1 + K + 2),
                                       2.0 * B * band_pairs(2048, 256) * c)),
            "knn_packed": (lambda x: knn_packed(x, K), lambda x: knn_packed_plain(x, K), 1,
                           bound(bnc * (c + 1 + 1 + K), 2.0 * B * N * N * c)),
            "knn_packed_split": (lambda x: knn_packed(x, K, splits=2),
                                 lambda x: knn_packed_split_plain(x, K), 1,
                                 bound(bnc * (c + 1 + 1 + K), 2.0 * B * N * N * c)),
        }
        for name, (run, plain, outputs, b) in cases.items():
            out.setdefault(name, {})[f"c{c}"] = _wide_case(
                f"{name} C={c}", run, plain, xi, xf, outputs, b)
        out["knn_exact"][f"c{c}"]["cloud_in_shared_memory"] = cloud_fits(N, 8 if c <= 8 else 16)
        idx = knn_capped(xf, K).reshape(B, N * K)
        got, want = gather_rows(xf, idx), gather_rows_plain(xf, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather_rows C={c}: kernel != plain on the scene's points")
        t = time_gather_rows(xf, idx)
        log(f"[wide] gather_rows C={c}: bit-equal, kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, torch.gather {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms")
        out.setdefault("gather_rows", {})[f"c{c}"] = {"max_abs_err": 0.0, **t}
    return out


def stage1_route(model, batches) -> dict:
    """The route stage 1 of the default forward takes on ``batches``: per
    batch the queries failing the band certificate in each cloud, the
    repaired ones (at most the budget of 256 a cloud, and only where the
    batch keeps the band) and whether the batch fell back to the capped
    kNN (a cloud failing more than the budget), read from the
    certificate's flags as ``repair_queries`` receives them."""
    import torch

    from dgcnn_tpu_torch.kernels import knn_banded as kb

    seen = []
    real = kb.repair_queries

    def repair(x, k, idx, fail, r_budget, pred):
        seen.append((fail.sum(1).tolist(), r_budget))
        return real(x, k, idx, fail, r_budget, pred)

    kb.repair_queries = repair
    try:
        with torch.inference_mode():
            for xb in batches:
                model(xb, band_mode=0)
    finally:
        kb.repair_queries = real
    if len(seen) != len(batches):
        raise AssertionError(f"stage 1 took the banded kNN in {len(seen)} of {len(batches)} "
                             "batches")
    fails = [f for f, _ in seen]
    fallback = [max(f) > budget for f, budget in seen]
    return {"batches": len(seen), "clouds": sum(len(f) for f in fails),
            "failing_queries": int(sum(map(sum, fails))),
            "failing_share": float(sum(map(sum, fails)) / (N * sum(len(f) for f in fails))),
            "repaired_queries": int(sum(sum(min(v, b) for v in f)
                                        for (f, b), fb in zip(seen, fallback) if not fb)),
            "capped_fallback_batches": int(sum(fallback)),
            "failing_per_cloud": fails}


def phase_wide_forward(blocks: dict, ckpts: dict) -> dict:
    """Phase 10b: full-width forwards (emb 1024, k=30, 3 classes) at F = 4,
    6 and 9 on the scene's blocks, with the checkpoints phase 10c trained
    (2 epochs) at each width: the default (``auto``), parity
    and packed modes, one batch each with the launch counters reset just
    before and read just after (the counts at F = 6 and 9 must be F = 4's,
    each kernel of the mode launched); probabilities of the default forward
    on two blocks within 1e-3 of the CPU plain forward with the card's kNN
    indices replayed there; stage 1's route on all the scene's batches; the
    default forward's synced time (CUDA events, median of 10) and device
    busy time (``torch.profiler``, 10 queued forwards), FP32 and bf16, on
    guarded, unguarded and fallback dispatches (``band_mode`` 1, 0, 2: the
    last is what the amortized guard sends after a trip), beside whether a
    guarded dispatch trips the feature bands' recall guard."""
    import torch

    from dgcnn_tpu_torch.eval.test import restore
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig
    from dgcnn_tpu_torch.utils.logging import IOStream
    from scripts.torch_profile_forward import profile

    modes = {"default": {}, "parity": dict(knn_impl="pallas"),
             "packed": dict(knn_impl="pallas_packed")}
    need = {"default": ("knn_banded", "knn_exact", "knn_capped", "edgeconv_fused_stage",
                        "edgeconv_fused_extrema"),
            "parity": ("knn_exact_banded", "knn_exact", "edgeconv_fused_stage",
                       "edgeconv_fused_extrema"),
            "packed": ("knn_packed", "edgeconv_fused_stage", "edgeconv_fused_extrema")}
    res = {"launches": {}, "route": {}, "ms": {}, "busy_ms": {}, "idle_share": {},
           "knn_ms": {}, "prob_diff_replayed": {}, "guard_tripped": {}}
    io = IOStream(os.devnull, stream=sys.stderr)
    for f in (4, *WIDE):
        cfg = DGCNNConfig(num_classes=3, num_features=f, k=K, emb_dims=1024)
        weights = restore(cfg, ckpts[f], "dgcnn_model", io, "cpu").state_dict()
        batches = [torch.from_numpy(blocks[f][i:i + B]).to("cuda")
                   for i in range(0, len(blocks[f]) - B + 1, B)]
        x = batches[0]
        models = {}
        for mode, kw in modes.items():
            models[mode] = DGCNN(dataclasses.replace(cfg, **kw)).to("cuda")
            models[mode].load_state_dict(weights)
            counters = reset_counters()
            with torch.inference_mode():
                out = models[mode](x, band_mode=1) if mode == "default" else models[mode](x)
            torch.cuda.synchronize()
            launches = {k_: fn.launches for k_, fn in counters.items()}
            if out.shape != (B, N, 3) or not torch.isfinite(out).all():
                raise AssertionError(f"[wide] F={f} {mode}: output {tuple(out.shape)}")
            if any(launches[k_] == 0 for k_ in need[mode]):
                raise AssertionError(f"[wide] F={f} {mode}: launches {launches}")
            if f != 4 and launches != res["launches"][f"F=4 {mode}"]:
                raise AssertionError(f"[wide] F={f} {mode}: launches {launches}, at F=4 "
                                     f"{res['launches'][f'F=4 {mode}']}")
            res["launches"][f"F={f} {mode}"] = launches
        gpu, cpu = models["default"], DGCNN(dataclasses.replace(cfg, knn_impl="pallas_capped"))
        cpu.load_state_dict(weights)
        two = x[:2]
        replay_knn(gpu, cpu)
        with torch.inference_mode():
            got = torch.softmax(gpu(two, band_mode=1), -1).cpu()
            want = torch.softmax(cpu(two.cpu()), -1)
        del gpu._knn, cpu._knn
        diff = (got - want).abs().max().item()
        if not diff <= 1e-3:
            raise AssertionError(f"[wide] F={f}: GPU vs CPU plain (kNN replayed) max prob "
                                 f"diff {diff}")
        res["prob_diff_replayed"][f"F={f}"] = diff
        res["route"][f"F={f}"] = route = stage1_route(models["default"], batches)
        with torch.inference_mode():
            res["guard_tripped"][f"F={f}"] = [
                bool(models["default"](xb, band_mode=1, with_band_flag=True)[1])
                for xb in batches]
        log(f"[wide] F={f}: launches {res['launches'][f'F={f} default']}; GPU vs CPU plain "
            f"(kNN replayed) max prob diff {diff:.2e}; stage 1 on {route['batches']} batches: "
            f"{route['failing_queries']} failing queries ({route['failing_share']:.4f}), "
            f"{route['repaired_queries']} repaired, {route['capped_fallback_batches']} "
            f"batches on the capped kNN; feature bands' guard tripped "
            f"{res['guard_tripped'][f'F={f}']}")
        bf16 = DGCNN(dataclasses.replace(cfg, compute_dtype="bfloat16")).to("cuda")
        bf16.load_state_dict(weights)
        for dtype, m in (("fp32", models["default"]), ("bf16", bf16)):
            for guard, mode in (("guarded", 1), ("unguarded", 0), ("fallback", 2)):
                key = f"F={f} {dtype} {guard}"

                def fn(m=m, mode=mode):
                    return m(x, band_mode=mode)

                with torch.inference_mode():
                    res["ms"][key] = cuda_ms(fn, 10)
                prof = profile(fn, 10)
                res["busy_ms"][key] = prof["busy_ms_per_forward"]
                res["idle_share"][key] = prof["idle_share"]
                res["knn_ms"][key] = {g: v["ms"] for g, v in prof["groups"].items()
                                      if g.startswith("knn")}
                log(f"[wide] forward {key}: synced {res['ms'][key]:.3f} ms/batch, busy "
                    f"{res['busy_ms'][key]:.3f} ms, idle share {res['idle_share'][key]:.4f}, "
                    f"kNN {res['knn_ms'][key]}")
    return res


def phase_wide_lifecycle(tile: str) -> dict:
    """Phase 10c: the lifecycle through the port's command line at F=6
    (``--mode process_data`` with ``params/features_wide.json`` and its
    ``--features_output``, 2 epochs at full width, ``--eval 1``,
    ``--predict`` of the tile with the same features) and at F=9 (the same
    but ``--eval 1``), after process_data and 2 epochs at F=4 (x y z agl:
    phase 10b's checkpoint at that width), the launch counters reset before
    and read after
    (stage 1 gathers the F-wide points; on raw intensity and colour the
    banded kNN's certificate fails and stage 1 takes the capped kNN). The
    rooms and checkpoints stay beside the tile (``npy<F>``, ``ckpt<F>``)."""
    from dgcnn_tpu_torch.__main__ import run
    from dgcnn_tpu_torch.io.las import read_las
    from scripts.torch_full_pipeline import WIDE_FEATURES_FILE, WIDE_OUTPUTS, process_data_argv

    root = os.path.dirname(os.path.dirname(tile))
    res = {"seconds": {}, "rooms": {}}
    cwd = os.getcwd()
    os.chdir(root)
    counters = reset_counters()
    try:
        for f in (4, *WIDE):
            names = WIDE_OUTPUTS.get(f, ["x", "y", "z", "agl"])
            npy, ckpt = os.path.join(root, f"npy{f}"), os.path.join(root, f"ckpt{f}")
            model = ["--num_points", str(N), "--num_classes", "3", "--num_features", str(f),
                     "--k", str(K), "--emb_dims", "1024", "--model_root", ckpt,
                     "--exp_name", f"wide{f}", "--features_file", WIDE_FEATURES_FILE,
                     "--features_output", *names]
            data = ["--data_dir", npy, "--validation_prop", "0.2"]
            t0 = time.perf_counter()
            run(process_data_argv(os.path.dirname(tile), os.path.join(root, f"pd{f}"), npy,
                                  features_output=names, features_file=WIDE_FEATURES_FILE))
            rooms = sorted(n_ for n_ in os.listdir(npy) if n_.endswith(".npy"))
            widths = {np.load(os.path.join(npy, n_)).shape[1] for n_ in rooms}
            if len(rooms) < 16 or widths != {f + 1}:
                raise AssertionError(f"[wide] F={f}: process_data wrote {len(rooms)} rooms "
                                     f"of widths {widths}")
            summary = run(["--mode", "classifier", "--eval", "0", *model, *data,
                           "--epochs", "2", "--batch_size", str(B),
                           "--validation_batch_size", str(B),
                           "--tb_dir", os.path.join(root, "tb")])
            if not summary["best_balanced_accuracy"] > 0:
                raise AssertionError(f"[wide] F={f}: train {summary}")
            res[f"F={f}"] = {"train": summary}
            log(f"[wide] lifecycle F={f}: {len(rooms)} rooms, train {summary}")
            if f == 4:  # a checkpoint of the same scene's x y z agl for phase 10b
                continue
            metrics = None
            if f == 6:
                metrics = run(["--mode", "classifier", "--eval", "1", *model, *data,
                               "--test_batch_size", str(B), "--min_class_confidence", "0.0",
                               "--test_visu_dir", os.path.join(root, "dumps")])
                if not np.isfinite([metrics["accuracy"], metrics["mean_iou"]]).all():
                    raise AssertionError(f"[wide] F={f}: eval {metrics}")
            out = run(["--mode", "classifier", "--predict", tile, "--predict_out",
                       os.path.join(root, f"classified{f}.las"), *model,
                       "--min_class_confidence", "0.0"])
            las = read_las(out[0])
            labels = set(np.unique(las.classification).tolist())
            if not len(las) or len(las) % N or not labels <= {0, 1, 2}:
                raise AssertionError(f"[wide] F={f}: --predict wrote {len(las)} points")
            res["seconds"][f"F={f}"] = time.perf_counter() - t0
            res["rooms"][f"F={f}"] = len(rooms)
            res[f"F={f}"].update({"predicted_points": len(las), "eval": None if metrics is None
                                  else {k_: metrics[k_] for k_ in
                                        ("accuracy", "balanced_accuracy", "mean_iou")}})
            log(f"[wide] lifecycle F={f}: eval {res[f'F={f}']['eval']}, predict {len(las)} "
                f"points; {res['seconds'][f'F={f}']:.2f} s in all")
    finally:
        os.chdir(cwd)
    res["launches"] = launches = {k_: fn.launches for k_, fn in counters.items()}
    log(f"[wide] lifecycle launches {launches}")
    need = ("knn_banded", "knn_capped", "knn_exact", "edgeconv_fused_stage",
            "edgeconv_fused_extrema", "gather_rows", "scatter_add_rows",
            "scatter_stage_tail_rows")
    if any(launches[k_] == 0 for k_ in need):
        raise AssertionError(f"[wide] lifecycle: kernels not launched: {launches}")
    return res


def phase_viz(root: str) -> dict:
    """Phase 10d: ``viz/features.py::_block_features`` of phase 10c's F=6
    checkpoint on a test-split block at depths 1, 3, 6 and 9, on the card
    against the CPU plain forward (the card's kNN replayed) at the depth
    taps' tolerance (atol = rtol = 2e-3); then ``--mode visualize``
    (clusters) through the port's command line: where scikit-learn or
    matplotlib is missing it must fail before loading anything, naming the
    package; where both are present it must write its files."""
    from dgcnn_tpu_torch.__main__ import run
    from dgcnn_tpu_torch.data.dataset import FugroDataset
    from dgcnn_tpu_torch.eval.test import restore
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig
    from dgcnn_tpu_torch.utils.logging import IOStream
    from dgcnn_tpu_torch.viz.features import _block_features, missing_packages

    res = {}
    io = IOStream(os.path.join(root, "viz.log"), stream=sys.stderr)
    cfg = DGCNNConfig(num_classes=3, num_features=6, k=K, emb_dims=1024)
    gpu = restore(cfg, os.path.join(root, "ckpt6"), "dgcnn_model", io, "cuda")
    cpu = DGCNN(dataclasses.replace(cfg, knn_impl="pallas_capped"))
    cpu.load_state_dict({k_: v.cpu() for k_, v in gpu.state_dict().items()})
    block = FugroDataset("test", os.path.join(root, "npy6"), num_point=N, seed=1,
                         validation_prop=0.2, classes=range(3))[0][0]
    res["viz_taps"] = {}
    for depth in (1, 3, 6, 9):
        replay_knn(gpu, cpu)
        got_f, got_p = _block_features(gpu, block, depth)
        want_f, want_p = _block_features(cpu, block, depth)
        del gpu._knn, cpu._knn
        if got_f.shape != want_f.shape or not np.allclose(got_f, want_f, atol=2e-3, rtol=2e-3):
            raise AssertionError(f"[viz] depth {depth}: card taps vs CPU plain, max abs "
                                 f"{np.abs(got_f - want_f).max()}")
        agree = float((got_p == want_p).mean())
        if agree < 0.999:
            raise AssertionError(f"[viz] depth {depth}: labels agree on {agree}")
        res["viz_taps"][depth] = {"max_abs": float(np.abs(got_f - want_f).max()),
                                  "label_agreement": agree}
    log(f"[viz] _block_features on the card vs the CPU plain forward: {res['viz_taps']}")
    missing = missing_packages()
    viz_dir = os.path.join(root, "viz")
    argv = ["--mode", "visualize", "--data_dir", os.path.join(root, "npy6"), "--num_points",
            str(N), "--num_classes", "3", "--num_features", "6", "--k", str(K),
            "--emb_dims", "1024", "--model_root", os.path.join(root, "ckpt6"),
            "--viz_kind", "clusters", "--viz_dir", viz_dir, "--exp_name", "viz"]
    vizrun = os.path.join(root, "vizrun")  # the CLI's log and run_config go here
    os.makedirs(vizrun)
    cwd = os.getcwd()
    os.chdir(vizrun)
    try:
        if missing:
            try:
                run(argv)
            except ImportError as e:
                if not all(p in str(e) for p in missing) or os.path.exists("checkpoints"):
                    raise AssertionError(f"[viz] --mode visualize without {missing}: {e}")
                res["visualize"] = f"refused before loading: {e}"
            else:
                raise AssertionError(f"[viz] --mode visualize ran without {missing}")
        else:
            written = run(argv)
            if not written or not all(os.path.getsize(p) for p in written):
                raise AssertionError(f"[viz] --mode visualize wrote {written}")
            res["visualize"] = f"wrote {written}"
    finally:
        os.chdir(cwd)
    log(f"[viz] --mode visualize: {res['visualize']}")
    return res


# ------------------------------------------------------------------ phase 12

RING_SHARDS = 4  # the point shards of phase 12, all on this card (see NCCL_RANKS)
# NCCL refuses two ranks on one device ("Duplicate GPU detected",
# scripts/torch_nccl_probe.py on the H100): the card runs the parallel paths
# at world size 1, one rank holding every shard
NCCL_RANKS = 1
PAR_TRAIN = (2, 28000)  # phase 12c's batch and points
PAR_SIZES = {"tile_n": 70000, "feat_c": 64}  # the CPU rehearsal shrinks these


def whole_tile(tmp: str, n: int) -> tuple[np.ndarray, str]:
    """Phase 4's 120 m x 60 m tile (``write_tile`` seed 100, ``n`` points)
    loaded as ``predict`` loads it (noise filter, DTM, AGL), as the model's
    whole-cloud input: x y z agl shifted, x-sorted, padded to a multiple of
    the shards (``eval/predict.py::whole_cloud_input``)."""
    from dgcnn_tpu_torch.eval.predict import predict_load, whole_cloud_input
    from dgcnn_tpu_torch.prepare.dtm import build_dtm, gen_agl

    path = os.path.join(tmp, "landing", "tile.las")
    os.makedirs(os.path.dirname(path))
    write_tile(path, 100, (120.0, 60.0), n)
    data, _ = predict_load(path)
    data = np.hstack([data[:, :3], gen_agl(build_dtm(data[:, :3]), data[:, :3])[:, None]])
    x, _ = whole_cloud_input(data, [0, 1, 2, 3], RING_SHARDS)
    return x, path


def _scores(x, q_idx_rows):
    """The k best scores ``2 q.c - |c|^2`` of each query, sorted: (B, M, k)."""
    import torch

    idx = q_idx_rows.long()
    b, m, k = idx.shape
    rows = torch.gather(x, 1, idx.reshape(b, -1, 1).expand(-1, -1, x.shape[-1])).reshape(
        b, m, k, -1)
    s = 2.0 * (x[:, :, None, :] * rows).sum(-1) - (rows * rows).sum(-1)
    return torch.sort(s, dim=-1, descending=True).values


def _ring(x, band: int, plain: bool = False):
    """The ring kNN of a whole (1, N, C) cloud over RING_SHARDS shards:
    ``(global idx (1, N, k), in-band flag, knn_exact launches)``; ``plain``
    runs each hop's plain version on the same device."""
    import torch

    from dgcnn_tpu_torch.kernels import knn_exact as ke
    from dgcnn_tpu_torch.parallel import ring_knn as rk
    from dgcnn_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, RING_SHARDS)
    counters = reset_counters()
    if plain:
        rk.knn_exact = lambda x_, k_, queries=None, query_rows=None: ke.knn_exact_plain(
            x_, k_, queries=queries)
    try:
        idx, flag = rk.ring_knn_local(rk.shard_points(x, mesh), K, mesh, band_shards=band,
                                      with_flag=True)
    finally:
        rk.knn_exact = ke.knn_exact
    if x.is_cuda:
        torch.cuda.synchronize()
    return rk.unshard_points(idx, mesh), bool(flag.all()), counters["knn_exact"].launches


def phase_ring_knn(x_np: np.ndarray, dev: str) -> dict:
    """Phase 12a: the ring kNN of the whole tile (C=4, stage 1's input) on
    the full ring and on the certified banded ring (``ring_band_shards``
    1), and of a C=64 feature cloud of the same N on the full ring: each
    hop's kernel against the ring whose hops run the plain version (bit for
    bit on integer-valued copies: decimetres, and integer features in
    [0, 16)); the k best scores equal to those of the flat exact kNN of the
    whole cloud (the neighbour sets may part only where scores tie across
    shards, which an integer cloud has plenty of); on the floats the sets
    against the flat exact kNN. Then one hop's kernel call against its plain
    version at the ring's shape, timed."""
    import torch

    from dgcnn_tpu_torch.kernels.knn_exact import knn_exact, knn_exact_plain

    out = {"n_points": int(x_np.shape[0]), "shards": RING_SHARDS, "cases": {}}
    x = torch.from_numpy(x_np)[None].to(dev)
    rng = np.random.default_rng(12)
    feats_int = torch.from_numpy(rng.integers(0, 16, (1, x.shape[1], PAR_SIZES["feat_c"]))
                                 .astype(np.float32)).to(dev)
    feats = torch.from_numpy(rng.standard_normal((1, x.shape[1], PAR_SIZES["feat_c"]))
                             .astype(np.float32)).to(dev)
    clouds = {"C=4 int": (torch.round(x * 10.0), (0, 1), True),
              "C=4 float": (x, (0, 1), False),
              f"C={PAR_SIZES['feat_c']} int": (feats_int, (0,), True),
              f"C={PAR_SIZES['feat_c']} float": (feats, (0,), False)}
    for name, (cloud, bands, int_valued) in clouds.items():
        flat = knn_exact(cloud, K)
        for band in bands:
            t0 = time.perf_counter()
            idx, flag, launches = _ring(cloud, band)
            ring_s = time.perf_counter() - t0
            case = {"band_shards": band, "in_band": flag, "knn_exact_launches": launches,
                    "seconds": ring_s}
            want_launches = RING_SHARDS if (band == 0 or not flag) else 3
            want_launches += 3 if (band and not flag) else 0
            if dev == "cuda" and launches != want_launches:  # the CPU counts no launch
                raise AssertionError(f"[ring] {name} band {band}: {launches} knn_exact launches, "
                                     f"expected {want_launches}")
            same_set = (torch.sort(idx, -1).values == torch.sort(flat, -1).values).all(-1)
            case["sets_equal_flat"] = float(same_set.float().mean())
            if int_valued:
                plain, pflag, _ = _ring(cloud, band, plain=True)
                if not torch.equal(idx, plain) or pflag != flag:
                    raise AssertionError(f"[ring] {name} band {band}: the kernel's ring differs "
                                         "from the plain version's")
                if not torch.equal(_scores(cloud, idx), _scores(cloud, flat)):
                    raise AssertionError(f"[ring] {name} band {band}: the ring's k best scores "
                                         "differ from the flat exact kNN's")
                case["bit_equal_plain_ring"] = True
                case["scores_equal_flat"] = True
            else:
                # a LAS tile's coordinates lie on the format's grid, so its
                # "floats" tie too; where the sets part, the k best scores
                # (the same function on both sets) may differ only where
                # the kernel's FP32 sum and the merge's part by an ulp
                got_s, want_s = _scores(cloud, idx), _scores(cloud, flat)
                rel = float(((got_s - want_s).abs() / want_s.abs().clamp_min(1.0)).max())
                case["scores_rel_flat"] = rel
                if rel > 1e-6:
                    raise AssertionError(f"[ring] {name} band {band}: the ring's k best scores "
                                         f"part from the flat exact kNN's by {rel:.2e}")
            out["cases"][f"{name} band {band}"] = case
            log(f"[ring] {name} band {band}: in band {flag}, {launches} knn_exact launches, "
                f"{ring_s:.3f} s, sets equal to the flat exact kNN {case['sets_equal_flat']:.6f}")
    # one hop at the ring's shape: shard 0's queries against shard 1 (the
    # kernel's hint: where each query's x sits), C=64 unsorted features (no
    # pruning: every pair scored) and the C=4 sorted cloud
    nl = x.shape[1] // RING_SHARDS
    hops = {}
    for name, cloud in (("c64", feats), ("c4", x)):
        sh = cloud.reshape(RING_SHARDS, nl, -1)
        q, cand = sh.roll(1, 0).contiguous(), sh.contiguous()
        rows = torch.searchsorted(cand[..., 0].contiguous(), q[..., 0].contiguous()).clamp_(
            max=nl - 1)
        got = knn_exact(cand, K, queries=q, query_rows=rows)
        want = knn_exact_plain(cand, K, queries=q)
        c = cloud.shape[-1]
        hop = {"shape": [RING_SHARDS, nl, c], "max_abs_err": float((got != want).sum())}
        if dev == "cuda":
            nbytes = 4.0 * RING_SHARDS * nl * (2 * c + 1 + K)
            ops = 2.0 * RING_SHARDS * nl * nl * c
            b_ms, b_by = bound(nbytes, ops) if name == "c64" else bound(nbytes, 0.0)
            hop.update(ms=cuda_ms_many(lambda: knn_exact(cand, K, queries=q, query_rows=rows),
                                       5, 5),
                       plain_ms=cuda_ms(lambda: knn_exact_plain(cand, K, queries=q), 3),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if not torch.equal(got, want) and name == "c64":
            raise AssertionError("[ring] the hop's kernel call differs from its plain version")
        hops[name] = hop
        log(f"[ring] hop {name} {hop}")
    out["hops"] = hops
    return out


def _expected_launches(flag: bool) -> dict:
    """Per sharded forward: stage 1's ring (banded: 3 hops, or 3 + the full
    ring's 4 where the certificate fails; its gather 3 or 4 hops), stages
    2 and 3 on the full ring (4 hops each)."""
    d = RING_SHARDS
    return {"knn_exact": (3 if flag else 3 + d) + 2 * d, "gather_rows": (3 if flag else d) + 2 * d}


def phase_whole_predict(tmp: str, x_np: np.ndarray, tile: str, stage1_flag: bool,
                        dev: str) -> dict:
    """Phase 12b: the whole tile as one forward over RING_SHARDS shards
    through ``predict(point_shards=4)``, the CLI's ``--predict
    --point_shards 4`` and the serve CLI's ``--point_shards 4`` (the same
    labels each, every point classified, the kernels' launches counted);
    its per-point probabilities against the unsharded forward of the same
    cloud in the parity mode (``knn_impl="pallas"``, the exact kNN; B=1);
    the time of the whole-tile forward beside the default path's forward of
    the same tile's blocks (``classify_all``: every point, in batches of 8)."""
    import torch

    from dgcnn_tpu_torch.__main__ import run
    from dgcnn_tpu_torch.eval.predict import _block_rows, assemble_batch, predict
    from dgcnn_tpu_torch.eval.test import restore
    from dgcnn_tpu_torch.io.las import read_las
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig
    from dgcnn_tpu_torch.parallel.mesh import make_mesh
    from dgcnn_tpu_torch.parallel.sharded_model import apply_dgcnn_sharded
    from dgcnn_tpu_torch.serve.__main__ import main as serve_main
    from dgcnn_tpu_torch.utils.logging import IOStream

    ckpt = os.path.join(tmp, "ckpt")
    write_checkpoint(os.path.join(ckpt, "dgcnn_model.npz"), DGCNNConfig(k=K, emb_dims=1024), 0)
    io = IOStream(os.path.join(tmp, "whole.log"), stream=sys.stderr)
    want = _expected_launches(stage1_flag)
    res = {"expected_launches": want}
    per_flag = [_expected_launches(f) for f in (True, False)]

    def counted(tag, fn):
        counters = reset_counters()
        t0 = time.perf_counter()
        out = fn()
        if dev == "cuda":
            torch.cuda.synchronize()
        launches = {k_: fn_.launches for k_, fn_ in counters.items()}
        res[tag] = {"seconds": time.perf_counter() - t0, "launches": launches}
        # predict loads the tile itself (the fused native load): its AGL,
        # and so stage 1's certificate, may part from whole_tile's by a bit
        got = {k_: launches[k_] for k_ in ("knn_exact", "gather_rows")}
        if dev == "cuda" and got not in per_flag:
            raise AssertionError(f"[whole] {tag}: launches {launches}, expected one of {per_flag}")
        log(f"[whole] {tag}: {res[tag]}")
        return out

    kw = dict(num_points=N, emb_dims=1024, model_root=ckpt, device=dev)
    data, pred = counted("predict", lambda: predict(
        K, io, tile, os.path.join(tmp, "api.las"), point_shards=RING_SHARDS, **kw))
    if len(pred) != len(data) or not set(np.unique(pred).tolist()) <= set(range(5)) | {31}:
        raise AssertionError(f"[whole] {len(pred)} labels for {len(data)} points")
    cwd = os.getcwd()
    os.chdir(tmp)  # the CLI's log: ./checkpoints/whole/run.log
    try:
        counted("cli", lambda: run(
            ["--mode", "classifier", "--predict", tile, "--predict_out",
             os.path.join(tmp, "cli.las"), "--point_shards", str(RING_SHARDS), "--k", str(K),
             "--num_points", str(N), "--num_features", "4", "--emb_dims", "1024",
             "--model_root", ckpt, "--exp_name", "whole", "--device", dev]))
    finally:
        os.chdir(cwd)
    served = os.path.join(tmp, "served")
    counted("serve_cli", lambda: serve_main(
        ["--in_dir", os.path.dirname(tile), "--out_dir", served, "--once", "--settle_s", "0",
         "--model_root", ckpt, "--k", str(K), "--num_points", str(N),
         "--point_shards", str(RING_SHARDS), "--device", dev,
         "--log", os.path.join(tmp, "serve.log")]))
    api = read_las(os.path.join(tmp, "api.las")).classification
    for other in (os.path.join(tmp, "cli.las"), os.path.join(served, "tile.las")):
        if not np.array_equal(read_las(other).classification, api):
            raise AssertionError(f"[whole] {other}'s labels differ from predict()'s")

    # probabilities against the unsharded parity forward of the same cloud
    model = restore(DGCNNConfig(k=K, emb_dims=1024), ckpt, "dgcnn_model", io, dev)
    parity = DGCNN(DGCNNConfig(k=K, emb_dims=1024, knn_impl="pallas")).to(dev).eval()
    parity.load_state_dict(model.state_dict())
    x = torch.from_numpy(x_np)[None].to(dev)
    mesh = make_mesh(1, RING_SHARDS)
    with torch.inference_mode():
        p_sh = torch.softmax(apply_dgcnn_sharded(model, x, mesh), -1)
        p_un = torch.softmax(parity(x), -1)
    diff = float((p_sh - p_un).abs().max())
    agree = float((p_sh.argmax(-1) == p_un.argmax(-1)).float().mean())
    res.update(prob_max_abs_diff=diff, argmax_agreement=agree)
    log(f"[whole] sharded vs unsharded parity forward, B=1 N={x.shape[1]}: probabilities "
        f"max |diff| {diff:.2e}, argmax agreement {agree:.6f}")
    if diff > 1e-3:
        raise AssertionError(f"[whole] probabilities differ by {diff} > 1e-3")
    if dev == "cuda":
        res["whole_forward_ms"] = cuda_ms(lambda: apply_dgcnn_sharded(model, x, mesh), 5)
        # the default path's forward of the same tile's blocks, every point
        rows, _ = _block_rows(data, np.zeros(len(data), np.int64), None, N, 30.0,
                              np.random.default_rng(0), True)
        batches = [torch.from_numpy(np.concatenate([c, np.repeat(c[-1:], B - len(c), 0)])
                                    ).to(dev) for c in (
            assemble_batch(data, rows[i:i + B], [0, 1, 2, 3]) for i in range(0, len(rows), B))]

        def blocked():
            with torch.inference_mode():
                for b_ in batches:
                    model(b_)

        res.update(blocked_batches=len(batches), blocked_points=int(rows.size),
                   blocked_forward_ms=cuda_ms(blocked, 5))
        log(f"[whole] whole-tile forward {res['whole_forward_ms']:.2f} ms "
            f"({x.shape[1]} points, {RING_SHARDS} shards) vs the default path's "
            f"{len(batches)} block batches {res['blocked_forward_ms']:.2f} ms "
            f"({rows.size} block points)")
    return res


def phase_sharded_train(dev: str, shape=None, steps: int = 3) -> dict:
    """Phase 12c: point-sharded training, B=2, N=28 000, k=30, emb 1024,
    RING_SHARDS shards, dropout 0: one step's loss and gradients against
    the unsharded step in the parity mode on the same batch and weights,
    the unsharded model replaying the ring's neighbour indices (each
    side's exact kNN may break a near-tie in feature space its own way;
    phase 12a holds the ring's exactness), so that the comparison is one of
    sum orders; the share of neighbour rows where the ring and the parity
    mode's own kNN part; the kernels' launches per step (the ring gather's
    backward: one ``scatter_add_rows`` per hop), then ``steps`` steps'
    median time (host clock, one loss read a step) and peak memory."""
    import torch

    from dgcnn_tpu_torch.models.dgcnn import DGCNNConfig
    from dgcnn_tpu_torch.parallel import sharded_model as sm
    from dgcnn_tpu_torch.parallel.mesh import make_mesh
    from dgcnn_tpu_torch.parallel.ring_knn import unshard_points
    from dgcnn_tpu_torch.parallel.sharded_model import make_sharded_train_step
    from dgcnn_tpu_torch.train.steps import init_train_state, make_train_step

    b, n = shape or PAR_TRAIN
    pts = torch.from_numpy(make_blocks(b, n, seed=12)).to(dev)
    rng = np.random.default_rng(12)
    labels = torch.from_numpy(rng.integers(0, 5, (b, n))).to(dev)
    mask = torch.ones((b, n), device=dev)
    cfg = DGCNNConfig(k=K, emb_dims=1024, dropout=0.0)
    mesh = make_mesh(1, RING_SHARDS)
    sharded = init_train_state(cfg, seed=4, device=dev)
    unsharded = init_train_state(dataclasses.replace(cfg, knn_impl="pallas"), seed=4, device=dev)
    step = make_sharded_train_step(cfg, mesh)
    seen, ring_stage = [], sm._ring_knn_stage

    def record(x, *a, **kw):
        idx, inband, s = ring_stage(x, *a, **kw)
        seen.append(unshard_points(idx, mesh))
        return idx, inband, s

    sm._ring_knn_stage = record
    counters = reset_counters()
    try:
        m = step(sharded, pts, labels, mask)
    finally:
        sm._ring_knn_stage = ring_stage
    launches = {k_: fn.launches for k_, fn in counters.items() if fn.launches}
    own, ring_idx = [], list(seen)

    def replay(x, *a, **kw):  # the parity model's own kNN, then the ring's
        own.append(type(unsharded.model)._knn(unsharded.model, x, *a, **kw))
        return seen.pop(0).to(x.device)

    unsharded.model._knn = replay
    m_ref = make_train_step(dataclasses.replace(cfg, knn_impl="pallas"))(
        unsharded, pts, labels, mask)
    del unsharded.model._knn
    parted = [float((torch.sort(a, -1).values != torch.sort(o, -1).values).any(-1).float().mean())
              for a, o in zip(ring_idx, own)]
    loss, loss_ref = float(m["loss"]), float(m_ref["loss"])
    g = {k_: p.grad for k_, p in sharded.model.named_parameters()}
    g_ref = {k_: p.grad for k_, p in unsharded.model.named_parameters()}
    floor = 1e-3 * max(v.norm().item() for v in g_ref.values())
    rels = {k_: _rel(g[k_].cpu(), g_ref[k_].cpu(), floor) for k_ in g}
    worst = max(rels, key=rels.get)
    res = {"shape": [b, n, K, 1024], "loss": loss, "loss_parity": loss_ref,
           "loss_rel": abs(loss - loss_ref) / abs(loss_ref), "worst_leaf": worst,
           "worst_rel": rels[worst], "launches_per_step": launches,
           "knn_rows_parted_per_stage": parted}
    log(f"[sharded train] B={b} N={n}: loss {loss:.7f} vs parity {loss_ref:.7f}, worst leaf "
        f"{worst} rel {rels[worst]:.2e}; neighbour rows where the ring and the parity kNN "
        f"part, per stage {parted}; launches {launches}")
    if res["loss_rel"] > 1e-5 or rels[worst] > 1e-2:
        raise AssertionError(f"[sharded train] against the unsharded step: {res}")
    hops = launches.get("gather_rows", 0)
    per_flag = [_expected_launches(f) for f in (True, False)]
    if dev == "cuda" and (launches.get("scatter_add_rows") != hops or {
            "knn_exact": launches.get("knn_exact"), "gather_rows": hops} not in per_flag):
        raise AssertionError(f"[sharded train] launches {launches}: the ring gather's backward "
                             f"should scatter once per gather hop, the hops {per_flag}")
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            float(step(sharded, pts, labels, mask)["loss"])
            times.append((time.perf_counter() - t0) * 1e3)
        res.update(step_ms=float(np.median(times)), step_ms_all=times,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"[sharded train] step {res['step_ms']:.1f} ms (all {[round(t, 1) for t in times]}), "
            f"peak memory {res['peak_memory_gb']:.2f} GB")
    return res


def phase_multiprocess_cli(tmp: str, dev: str) -> dict:
    """Phase 12d: ``python -m dgcnn_tpu_torch --num_processes 1
    --coordinator_address 127.0.0.1:<port>`` (the CLI in-process: a process
    group over NCCL, NCCL_RANKS rank(s) on this card) trains 1 epoch on phase
    7's rooms; ``eval/test.py`` restores what it wrote and one tile is served
    from it."""
    import socket

    import torch
    import torch.distributed as dist

    from dgcnn_tpu_torch.__main__ import run
    from dgcnn_tpu_torch.eval.test import test
    from dgcnn_tpu_torch.parallel.distributed import shutdown
    from dgcnn_tpu_torch.utils.logging import IOStream

    rooms, root = os.path.join(tmp, "rooms"), os.path.join(tmp, "mp_ckpt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = ["--mode", "classifier", "--eval", "0", "--data_dir", rooms, "--num_points", str(N),
            "--num_features", "4", "--k", str(K), "--emb_dims", "1024", "--epochs", "1",
            "--batch_size", str(B), "--validation_batch_size", str(B), "--model_root", root,
            "--exp_name", "multiprocess", "--tb_dir", os.path.join(tmp, "tb_mp"),
            "--num_processes", str(NCCL_RANKS), "--process_id", "0",
            "--coordinator_address", f"127.0.0.1:{port}", "--device", dev]
    cwd = os.getcwd()
    os.chdir(tmp)
    t0 = time.perf_counter()
    try:
        summary = run(argv)
        backend = dist.get_backend() if dist.is_initialized() else None
    finally:
        shutdown()
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    if dev == "cuda" and backend != "nccl":
        raise AssertionError(f"[multiprocess] the process group's backend is {backend}")
    ckpt = os.path.join(root, "dgcnn_model.npz")
    io = IOStream(os.path.join(tmp, "mp_eval.log"), stream=sys.stderr)
    metrics = test(K, io, data_dir=rooms, model_root=root, num_points=N, num_features=4,
                   test_batch_size=B, emb_dims=1024, validation_prop=0.8, seed=1,
                   min_class_confidence=0.0, pred_dir=os.path.join(tmp, "mp_pred"), device=dev)
    res = {"world_size": NCCL_RANKS, "backend": backend, "train_s": wall, "summary": summary,
           "checkpoint_is_dir": os.path.isdir(ckpt), "test": {
               k_: float(v) for k_, v in metrics.items() if np.ndim(v) == 0}}
    if not os.path.exists(ckpt) or not np.isfinite(res["test"]["accuracy"]):
        raise AssertionError(f"[multiprocess] {res}")
    if dev == "cuda":
        res["served_launches"], _ = serve_tiles(tmp, "multiprocess",
                                                {"tile": (301, (120.0, 60.0), 70000)},
                                                model_root=root)
    log(f"[multiprocess] {res}")
    return res


def phase_tensor_parallel(dev: str, shape=(B, N)) -> dict:
    """Phase 12e: the trunk cut over 2 shards (``tensor_parallel`` 2) on the
    default forward at full width: its logits within 1e-5 of the
    replicated trunk's (the same kNN and stages; conv7 sums its partial
    products in another order), and ``tp_shard_info`` showing the halves."""
    import torch

    from dgcnn_tpu_torch.models.dgcnn import DGCNNConfig, init_dgcnn
    from dgcnn_tpu_torch.parallel.mesh import make_mesh
    from dgcnn_tpu_torch.parallel.tensor_parallel import shard_params_tp, tp_shard_info

    model = init_dgcnn(DGCNNConfig(k=K, emb_dims=1024), torch.Generator().manual_seed(5),
                       device=dev)
    x = torch.from_numpy(make_blocks(*shape, seed=13)).to(dev)
    with torch.inference_mode():
        rep = model(x)
        shard_params_tp(model, make_mesh(1, 2))
        tp = model(x)
    diff = float((tp - rep).abs().max())
    info = {k_: v for k_, v in tp_shard_info(model).items() if k_ in (
        "conv6/w", "bn6/gamma", "conv7/w", "conv8/w")}
    res = {"logits_max_abs_diff": diff, "logits_max_abs": float(rep.abs().max()),
           "shard_bytes": info}
    log(f"[tensor parallel] 2 shards: logits max |diff| {diff:.2e}; shard bytes {info}")
    if diff > 1e-5 + 1e-5 * res["logits_max_abs"] or info["conv6/w"] != 192 * 512 * 4:
        raise AssertionError(f"[tensor parallel] {res}")
    return res


def phase_parallel_kernels(dev: str, x_np: np.ndarray) -> dict:
    """The ring's row kernels at its shapes (RING_SHARDS shards of the
    whole tile, k=30, C=64): ``gather_rows`` and ``scatter_add_rows``
    against their plain versions and the library calls, timed as phase 2
    times them."""
    import torch

    from dgcnn_tpu_torch.kernels.gather_rows import gather_rows, gather_rows_plain
    from dgcnn_tpu_torch.kernels.scatter_rows import scatter_add_rows, scatter_add_rows_plain

    nl = x_np.shape[0] // RING_SHARDS
    rng = np.random.default_rng(14)
    table = torch.from_numpy(rng.standard_normal((RING_SHARDS, nl, 64)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, nl, (RING_SHARDS, nl * K)).astype(np.int32)).to(dev)
    dy = torch.from_numpy(rng.standard_normal((RING_SHARDS, nl * K, 64)).astype(np.float32)).to(dev)
    g = {"max_abs_err": float((gather_rows(table, idx) - gather_rows_plain(table, idx)).abs().max())}
    got, want = scatter_add_rows(dy, idx, nl), scatter_add_rows_plain(dy, idx, nl)
    s = {"max_abs_err": float((got - want).abs().max())}
    if g["max_abs_err"] != 0.0 or s["max_abs_err"] > 1e-4:
        raise AssertionError(f"[ring rows] gather {g}, scatter {s}")
    if dev == "cuda":
        g.update(time_gather_rows(table, idx))
        s.update(time_scatter_rows(dy, idx, nl))
    log(f"[ring rows] gather_rows {g}; scatter_add_rows {s}")
    return {"gather_rows": g, "scatter_add_rows": s}


def phase_parallel(tmp: str, dev: str = "cuda") -> dict:
    """Phase 12: the parallel paths on the card (a-e above)."""
    t0 = time.perf_counter()
    x, tile = whole_tile(os.path.join(tmp, "whole"), PAR_SIZES["tile_n"])
    ring = phase_ring_knn(x, dev)
    flag = ring["cases"]["C=4 float band 1"]["in_band"]
    res = {"ring_knn": ring, "rows": phase_parallel_kernels(dev, x),
           "whole_predict": phase_whole_predict(os.path.join(tmp, "whole"), x, tile, flag, dev),
           "sharded_train": phase_sharded_train(dev),
           "multiprocess": phase_multiprocess_cli(tmp, dev),
           "tensor_parallel": phase_tensor_parallel(dev)}
    res["seconds"] = time.perf_counter() - t0
    log(f"[parallel] phase 12 ran in {res['seconds']:.1f} s")
    return res


# ------------------------------------------------------------------ phase 13

TF32_FLOP_PER_S = 495e12  # dense, on the tensor cores
# (label, compute_dtype, matmul_precision) of phase 13's forwards, each
# against the CPU plain forward of the same configuration; then FP32 and
# bf16, timed beside them
PRECISION_CONFIGS = (("tf32", None, "default"), ("high", None, "high"),
                     ("highest", None, "highest"), ("f16", "float16", None),
                     ("float32", "float32", None), ("bf16 highest", "bfloat16", "highest"))
PRECISION_TIMED = (("fp32", None, None), ("bf16", "bfloat16", None))
# launches a forward: (FP32 stage, TF32 stage, bf16 stage, extrema)
PRECISION_LAUNCHES = {"tf32": (0, 2, 0, 1), "high": (2, 0, 0, 1), "highest": (0, 0, 0, 0),
                      "f16": (0, 0, 0, 0), "float32": (0, 0, 0, 0), "bf16 highest": (0, 0, 0, 0),
                      "fp32": (2, 0, 0, 1), "bf16": (0, 0, 2, 1)}
# the card's training step against the CPU plain one on the card's graph:
# the bounds tests/test_torch_precision.py sets against JAX for the mode,
# twice JAX's own spread (TF32: its FP32 gradient under +-2^-11 weight
# noise, 32% a leaf and 4.1e-4 in the loss; f16: its f16 gradient under a
# 2^-22 weight scaling, 4.5% and 4.2e-5)
PRECISION_GRAD_REL = {"tf32": 0.64, "f16": 0.09}
PRECISION_LOSS = {"tf32": 8.2e-4, "f16": 8.3e-5}


def _stage_launches(counters) -> tuple:
    return tuple(counters[k_].launches for k_ in (
        "edgeconv_fused_stage", "edgeconv_fused_stage_tf32", "edgeconv_fused_stage_bf16",
        "edgeconv_fused_extrema"))


def ptxas_of(fragment: str) -> list[str]:
    """The port's build log's register, stack and spill lines of the entry
    functions whose mangled name holds ``fragment``."""
    from dgcnn_tpu_torch.kernels import _build

    path = _build.library_path().with_suffix(".log")
    lines, hit = [], False
    for line in (path.read_text() if path.exists() else "").splitlines():
        if "Compiling entry function" in line:
            hit = fragment in line
        elif hit and ("Used" in line or "spill" in line):
            lines.append(line.split("ptxas info    :")[-1].strip())
    return lines


def phase_precision_kernel(dev, l2: dict | None = None) -> dict:
    """Phase 13a: the TF32 stage kernel against its plain version on every
    :func:`stage_cases` case, within ``stage_tf32_tolerance`` (two FP32 sum
    orders of the same exact TF32 products), and bit for bit on integer
    operands at the production shape (every product and partial sum exact);
    timed by :func:`cuda_ms_many` beside the FP32 (row 2) and bf16 (row 12)
    kernels on the same inputs, and cuBLAS's TF32 GEMM on the bare
    (B*N*k, 64) x (64, 64) product as a ceiling. Each production case gets
    the kernel's share of each bound: TF32 operations at 495 TFLOP/s, bytes
    at 3.35 TB/s and, given phase 2's ``l2`` measurement, the gather's rows
    at the card's L2 read rate; the result carries the kernel's registers
    and spills from the build log."""
    import torch

    from dgcnn_tpu_torch.kernels.edgeconv_fused import (
        edgeconv_fused_stage, edgeconv_fused_stage_plain, edgeconv_fused_stage_tf32,
        edgeconv_fused_stage_tf32_plain, stage_tf32_tolerance)
    from dgcnn_tpu_torch.ops.matmul import tf32_enabled

    inputs = stage_cases(dev)
    cases = []
    for label, case in inputs.items():
        a = stage_args(case)
        got = edgeconv_fused_stage_tf32(*a)
        torch.cuda.synchronize()
        want = edgeconv_fused_stage_tf32_plain(*a)
        tol = stage_tf32_tolerance(*a[:7], a[7])
        err = (got - want).abs()
        row = {"case": label, "max_abs_err": err.max().item(),
               "tolerance_share": (err / tol.clamp_min(1e-30)).max().item(),
               "vs_fp32_max_abs": (got - edgeconv_fused_stage_plain(*a)).abs().max().item()}
        if not (err <= tol).all():
            raise AssertionError(f"edgeconv_fused_stage_tf32 {label}: beyond the tolerance ({row})")
        del tol, err, want
        if not label.startswith("ragged"):
            row["ms"] = cuda_ms_many(lambda a=a: edgeconv_fused_stage_tf32(*a))
            row["f32_ms"] = cuda_ms_many(lambda a=a: edgeconv_fused_stage(*a))
            row["bf16_ms"] = cuda_ms_many(lambda a=a: edgeconv_fused_stage(*a, bf16_mm=True))
            if not cases:
                row["plain_ms"] = cuda_ms(lambda a=a: edgeconv_fused_stage_tf32_plain(*a), 5)
        log(f"[precision] edgeconv_fused_stage_tf32 {label}: max abs diff "
            f"{row['max_abs_err']:.3e} ({row['tolerance_share']:.3f} of the tolerance), "
            f"{row['vs_fp32_max_abs']:.3e} from the FP32 stage" + "".join(
                f", {key} {row[key]:.4f}" for key in ("ms", "f32_ms", "bf16_ms", "plain_ms")
                if key in row))
        cases.append(row)
    # integer operands (e = 5m, lrelu(-5m) = -m) on the production indices
    rng = np.random.default_rng(13)

    def on(v):
        return torch.from_numpy(np.asarray(v, np.float32)).to(dev)

    prod = inputs["capped C=64"]
    ints = (on(rng.integers(-3, 4, (B, N, 64))), prod["idx"], on(rng.integers(-3, 4, (B, N, 64))),
            on(rng.integers(-3, 4, (64, 64))), on(rng.choice([-5.0, 5.0], 64)),
            on(5.0 * rng.integers(-2, 3, 64)), prod["sb"], prod["tb"])
    got = edgeconv_fused_stage_tf32(*ints)
    torch.cuda.synchronize()
    if not (torch.equal(got, edgeconv_fused_stage_tf32_plain(*ints))
            and torch.equal(got, edgeconv_fused_stage(*ints))):
        raise AssertionError("edgeconv_fused_stage_tf32: not bit for bit on integer operands")
    cases.append({"case": "integers (capped C=64 indices)", "max_abs_err": 0.0})
    log("[precision] edgeconv_fused_stage_tf32 on integer operands: equal to its plain "
        "version and to the FP32 stage kernel, bit for bit")
    x = torch.randn(B * N * K, 64, device=dev)
    w2 = prod["w2"]
    with tf32_enabled():
        cublas_tf32 = cuda_ms_many(lambda: torch.mm(x, w2))
    del x
    nbytes = 4.0 * B * N * (3 * 64 + K) + 4.0 * (64 * 64 + 4 * 64)
    b_ms, b_by = bound(nbytes, 2.0 * B * N * K * 64 * 64, TF32_FLOP_PER_S)
    bounds = {"operations": 2.0 * B * N * K * 64 * 64 / TF32_FLOP_PER_S * 1e3,
              "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    if l2 is not None:
        bounds["l2_gather"] = l2["ms"]
    for row in cases:
        if "ms" in row:
            row["share_of_bound"] = {key: v / row["ms"] for key, v in bounds.items()}
    ptxas = ptxas_of("edgeconv_stage_tf32_kernel")
    log(f"[precision] bare (B*N*k, 64) x (64, 64) product, cuBLAS TF32: {cublas_tf32:.4f} ms; "
        f"the TF32 stage's bound {b_ms:.4f} ms ({b_by}); its bounds "
        + ", ".join(f"{key} {v:.4f} ms" for key, v in bounds.items())
        + "; shares of them: " + "; ".join(
            f"{row['case']}: " + ", ".join(f"{key} {v:.3f}" for key, v in
                                           row["share_of_bound"].items())
            for row in cases if "share_of_bound" in row)
        + f"; ptxas: {ptxas}")
    return {"max_abs_err": max(r["max_abs_err"] for r in cases), "ms": cases[0]["ms"],
            "plain_ms": cases[0]["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "bounds_ms": bounds, "share_of_bound": cases[0]["share_of_bound"],
            "ptxas": ptxas, "f32_ms": cases[0]["f32_ms"], "bf16_ms": cases[0]["bf16_ms"],
            "cublas_tf32_ms": cublas_tf32, "cases": cases}


def _knn_leak_check(model, f32, x) -> int:
    """Run ``model``'s forward on ``x`` recording each kNN call, then repeat
    every call on the FP32 model (TF32 off) with the same inputs: the
    indices must be equal. Returns the calls checked."""
    import torch

    from dgcnn_tpu_torch.models.dgcnn import DGCNN

    seen = []

    def record(v, *a, **kw):
        out = DGCNN._knn(model, v, *a, **kw)
        seen.append((v.clone(), a, kw, out))
        return out

    model._knn = record
    try:
        with torch.inference_mode():
            model(x, band_mode=0)
    finally:
        del model._knn
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("[precision] TF32 left enabled after a forward")
    for i, (v, a, kw, out) in enumerate(seen):
        with torch.inference_mode():
            ref = DGCNN._knn(f32, v, *a, **kw)
        if not torch.equal(ref, out):
            raise AssertionError(f"[precision] kNN call {i}: indices differ from the FP32 "
                                 "kNN's on the same features")
    return len(seen)


def phase_precision_forward(dev) -> dict:
    """Phase 13b: the production forward under every configuration of
    :data:`PRECISION_CONFIGS` against the CPU plain forward of the same
    configuration (2, 2048), against the FP32 forward on the production
    batch, its launches and its synced time; the kNN under "default" never
    sees TF32."""
    import dataclasses as dc

    import torch

    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn
    from dgcnn_tpu_torch.utils.profiling import measure

    base = DGCNNConfig(k=K, emb_dims=1024)
    weights = init_dgcnn(base, torch.Generator().manual_seed(1)).state_dict()
    x = torch.from_numpy(make_blocks(B, N, seed=0)).to(dev)
    small = torch.from_numpy(make_blocks(2, 2048, seed=2))

    def model(cfg, where):
        m = DGCNN(cfg)
        m.load_state_dict(weights)
        return m.to(where)

    f32 = model(base, dev)
    with torch.inference_mode():
        p32 = torch.softmax(f32(x, band_mode=0), -1)
    res = {}
    for label, cd, pr in PRECISION_CONFIGS + PRECISION_TIMED:
        cfg = DGCNNConfig(k=K, emb_dims=1024, compute_dtype=cd, matmul_precision=pr)
        gpu = model(cfg, dev)
        row = {}
        if (label, cd, pr) in PRECISION_CONFIGS:
            cpu = model(dc.replace(cfg, knn_impl="pallas_capped"), "cpu")
            with torch.inference_mode():
                want = torch.softmax(cpu(small), -1)
                got = torch.softmax(gpu(small.to(dev)), -1).cpu()
            row["cpu_max_prob_diff"] = (got - want).abs().max().item()
            if not row["cpu_max_prob_diff"] <= 1e-3:
                raise AssertionError(f"[precision] {label}: GPU vs CPU plain {row}")
        counters = reset_counters()
        with torch.inference_mode():
            logits = gpu(x, band_mode=0)
        torch.cuda.synchronize()
        row["launches"] = _stage_launches(counters)
        if row["launches"] != PRECISION_LAUNCHES[label]:
            raise AssertionError(f"[precision] {label}: stage launches {row['launches']}, "
                                 f"expected {PRECISION_LAUNCHES[label]}")
        probs = torch.softmax(logits, -1)
        row["nonfinite_logits"] = int((~torch.isfinite(logits)).sum())
        row["nonfinite_probs"] = int((~torch.isfinite(probs)).sum())
        row["vs_fp32_max_prob_diff"] = (probs - p32).abs().max().item()
        row["vs_fp32_argmax_agreement"] = (probs.argmax(-1) == p32.argmax(-1)).float().mean().item()
        if label != "f16" and (row["nonfinite_logits"] or logits.shape != (B, N, 5)):
            raise AssertionError(f"[precision] {label}: {row}")
        with torch.inference_mode():
            row["ms"] = cuda_ms(lambda: gpu(x, band_mode=0), 10)
            row["measure"] = measure(lambda: gpu(x, band_mode=0), iters=10)
        log(f"[precision] forward {label} (B={B} N={N}): {row['ms']:.3f} ms synced (CUDA "
            f"events, median of 10), {row['measure']['sec_per_call'] * 1e3:.3f} ms by "
            f"profiling.measure; vs FP32 max prob diff {row['vs_fp32_max_prob_diff']:.3e}, "
            f"argmax {row['vs_fp32_argmax_agreement']:.6f}; GPU vs CPU plain "
            f"{row.get('cpu_max_prob_diff', float('nan')):.2e}; launches (FP32 stage, TF32 "
            f"stage, bf16 stage, extrema) {row['launches']}; non-finite logits "
            f"{row['nonfinite_logits']}, probabilities {row['nonfinite_probs']}")
        res[label] = row
        del gpu
    # "default": each kNN call of the forward gives the FP32 model's indices
    # on the same features, stage 1 the FP32 forward's own; on the exact
    # kNN (knn_impl="xla": torch.matmul scores through cuBLAS) too, where
    # TF32 left on would change the scores
    tf32 = model(DGCNNConfig(k=K, emb_dims=1024, matmul_precision="default"), dev)
    calls = _knn_leak_check(tf32, f32, x)
    xla = model(DGCNNConfig(k=K, emb_dims=1024, matmul_precision="default", knn_impl="xla"),
                dev)
    xla_calls = _knn_leak_check(xla, model(dc.replace(base, knn_impl="xla"), dev), small.to(dev))
    with torch.inference_mode():
        same_stage1 = torch.equal(DGCNN._knn(tf32, x, "pallas_capped", spatial=True),
                                  DGCNN._knn(f32, x, "pallas_capped", spatial=True))
    if not same_stage1:
        raise AssertionError("[precision] stage 1's indices differ from the FP32 forward's")
    res["knn_checked_calls"] = {"default": calls, "xla": xla_calls}
    log(f"[precision] kNN under \"default\": {calls} calls of the default path and {xla_calls} "
        "of the exact (torch.matmul) path equal the FP32 kNN's on the same features; stage 1 "
        "equal to the FP32 forward's")
    return res


def phase_precision_train(tmp: str, dev) -> dict:
    """Phase 13c: 10 steps each under "default" (TF32) and "float16" on
    phase 7's fixed batch (``profiling.StepTimer``: the median of steps
    6-10, one loss read a step), the peak, the loss falling; one step's
    gradients (2, 2048) against the CPU plain versions on the card's graph."""
    import dataclasses as dc

    import torch

    from dgcnn_tpu_torch.data.dataset import FugroDataset
    from dgcnn_tpu_torch.data.prefetch import to_device
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn
    from dgcnn_tpu_torch.train.steps import (
        BandGuardScheduler, init_train_state, make_train_step)
    from dgcnn_tpu_torch.utils.profiling import StepTimer

    data = FugroDataset("train", os.path.join(tmp, "rooms"), num_point=N, seed=1)
    batch = next(data.batches(B, epoch=0))
    pts, labels, mask = to_device((batch.points, batch.labels, batch.mask), dev)
    shape = (2, 2048)
    small = torch.from_numpy(make_blocks(*shape, seed=6))
    rng = np.random.default_rng(6)
    lab = torch.from_numpy(rng.integers(0, 5, shape))
    msk = torch.from_numpy((rng.random(shape) < 0.7).astype(np.float32))
    res = {}
    for label, cd, pr in (("tf32", None, "default"), ("f16", "float16", None)):
        cfg = DGCNNConfig(k=K, emb_dims=1024, compute_dtype=cd, matmul_precision=pr)
        state = init_train_state(cfg, seed=2, device=dev, epochs=30)
        sched = BandGuardScheduler(cfg, dev)
        step = make_train_step(cfg, band_guard=sched.active)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timer, losses = StepTimer(), []
        for _ in range(10):
            with timer:
                mode, guarded = sched.next_mode() if sched.active else (None, False)
                metrics = step(state, pts, labels, mask, mode)
                if guarded:
                    loss, flag = torch.stack([metrics["loss"],
                                              metrics["band_tripped"].float()]).tolist()
                    sched.observe(bool(flag))
                else:
                    loss = float(metrics["loss"])
            losses.append(loss)
        peak = torch.cuda.max_memory_allocated() / 1e9
        step_ms = float(np.median(timer.times[5:])) * 1e3
        if not all(np.isfinite(losses)) or not np.mean(losses[-3:]) < losses[0]:
            raise AssertionError(f"[precision] {label}: the loss did not fall: {losses}")
        del state, step
        # gradients: the card's step, the CPU plain step replaying its graph,
        # and the CPU's FP32 step on that graph (the distance a mode makes)
        gcfg = dc.replace(cfg, dropout=0.0)
        weights = init_dgcnn(gcfg, torch.Generator().manual_seed(3)).state_dict()
        card = DGCNN(gcfg)
        card.load_state_dict(weights)
        card = card.to(dev).train()
        graph = []

        def record(*args, card=card, graph=graph, **kwargs):
            graph.append(DGCNN._knn(card, *args, **kwargs))
            return graph[-1]

        card._knn = record
        got = _grads(card, small.to(dev), lab.to(dev), msk.to(dev))
        grads = {}
        for name, c in (("plain", gcfg), ("fp32", dc.replace(gcfg, compute_dtype=None,
                                                             matmul_precision=None))):
            m = DGCNN(dc.replace(c, knn_impl="pallas_capped"))
            m.load_state_dict(weights)
            queue = list(graph)
            m._knn = lambda v, *a, queue=queue, **kw: queue.pop(0).to(v.device)
            grads[name] = _grads(m.train(), small, lab, msk)
        worst = _worst_rel(got[1], grads["plain"][1])
        loss_diff = abs(got[0] - grads["plain"][0])
        fp32_worst = _worst_rel(grads["fp32"][1], grads["plain"][1])
        res[label] = {"step_ms": step_ms, "timer": timer.summary(), "step_ms_all":
                      [t * 1e3 for t in timer.times], "peak_gb": peak, "losses": losses,
                      "grad_worst": worst, "loss_diff": loss_diff,
                      "fp32_grad_worst": fp32_worst,
                      "fp32_loss_diff": abs(grads["fp32"][0] - grads["plain"][0])}
        log(f"[precision] train {label}: step {step_ms:.3f} ms (median of steps 6-10, "
            f"StepTimer {timer.summary()}), peak {peak:.3f} GB, losses "
            f"{[round(v, 4) for v in losses]}; gradients (2, 2048) GPU vs CPU plain on the "
            f"card's graph: worst leaf {worst}, loss diff {loss_diff:.2e} (the CPU's FP32 step "
            f"from its {label} step: {fp32_worst}, loss {res[label]['fp32_loss_diff']:.2e})")
        if worst[1] > PRECISION_GRAD_REL[label] or loss_diff > PRECISION_LOSS[label]:
            raise AssertionError(f"[precision] {label}: GPU vs CPU gradients {res[label]}")
    return res


def phase_precision_cli(tmp: str, dev) -> dict:
    """Phase 13d: one tile served by the serve CLI with ``--matmul_precision
    default`` (the TF32 stage kernel, twice a batch, and no FP32 one),
    ``--eval 1`` on phase 7's checkpoint with ``--compute_dtype float16``
    (no stage kernel), one CLI epoch with ``--matmul_precision highest``."""
    import torch

    from dgcnn_tpu_torch.__main__ import run as port_cli
    from dgcnn_tpu_torch.serve.__main__ import main as serve_main

    rooms, root = os.path.join(tmp, "rooms"), os.path.join(tmp, "trained")
    landing, out = os.path.join(tmp, "tf32_landing"), os.path.join(tmp, "tf32_out")
    os.makedirs(landing)
    write_tile(os.path.join(landing, "tile.las"), 303, (120.0, 60.0), 70000)
    res = {}
    counters = reset_counters()
    t0 = time.perf_counter()
    rc = serve_main(["--in_dir", landing, "--out_dir", out, "--once", "--settle_s", "0",
                     "--model_root", root, "--k", str(K), "--num_points", str(N),
                     "--matmul_precision", "default", "--device", dev,
                     "--log", os.path.join(tmp, "tf32_serve.log")])
    torch.cuda.synchronize()
    res["serve_s"] = time.perf_counter() - t0
    res["serve_launches"] = {name: fn.launches for name, fn in counters.items()}
    stage = _stage_launches(counters)
    if rc or not os.path.exists(os.path.join(out, "tile.las")) or stage[0] or stage[2] \
            or stage[1] < 2 or stage[1] != 2 * stage[3]:
        raise AssertionError(f"[precision] serve CLI --matmul_precision default: rc {rc}, "
                             f"stage launches {stage}")
    model_args = ["--data_dir", rooms, "--k", str(K), "--num_points", str(N),
                  "--num_features", "4", "--emb_dims", "1024", "--device", dev]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        counters = reset_counters()
        t0 = time.perf_counter()
        metrics = port_cli(["--mode", "classifier", "--eval", "1", *model_args,
                            "--model_root", root, "--compute_dtype", "float16",
                            "--exp_name", "f16_eval", "--test_batch_size", str(B),
                            "--validation_prop", "0.8", "--min_class_confidence", "0.0",
                            "--test_visu_dir", os.path.join(tmp, "pred_f16")])
        res["eval_f16_s"] = time.perf_counter() - t0
        eval_stage = _stage_launches(counters)
        counters = reset_counters()
        t0 = time.perf_counter()
        summary = port_cli(["--mode", "classifier", "--eval", "0", *model_args,
                            "--model_root", os.path.join(tmp, "highest_trained"),
                            "--matmul_precision", "highest", "--exp_name", "highest",
                            "--epochs", "1", "--batch_size", str(B),
                            "--validation_batch_size", str(B), "--validation_prop", "0.2",
                            "--tb_dir", os.path.join(tmp, "tb_highest")])
        res["train_highest_s"] = time.perf_counter() - t0
        train_stage = _stage_launches(counters)
    finally:
        os.chdir(cwd)
    res.update({"eval_f16": {"accuracy": metrics["accuracy"], "mean_iou": metrics["mean_iou"]},
                "train_highest": summary})
    log(f"[precision] serve CLI --matmul_precision default: 1 tile in {res['serve_s']:.2f} s, "
        f"stage launches {stage}; --eval 1 --compute_dtype float16 ({res['eval_f16_s']:.2f} s): "
        f"acc {metrics['accuracy']:.6f}, mean IoU {metrics['mean_iou']:.6f}; one epoch "
        f"--matmul_precision highest ({res['train_highest_s']:.2f} s): {summary}")
    if any(eval_stage) or any(train_stage) \
            or not np.isfinite([metrics["mean_iou"], summary["val_balanced_accuracy"]]).all():
        raise AssertionError(f"[precision] CLI: eval stage launches {eval_stage}, train "
                             f"{train_stage}, {metrics}, {summary}")
    return res


def phase_precision(tmp: str, dev: str = "cuda", l2: dict | None = None) -> dict:
    """Phase 13: precision and dtypes (a-d above); ``l2``: phase 2's L2 read
    rate of the gather, the TF32 stage kernel's third bound."""
    t0 = time.perf_counter()
    res = {"kernel": phase_precision_kernel(dev, l2), "forward": phase_precision_forward(dev),
           "train": phase_precision_train(tmp, dev), "cli": phase_precision_cli(tmp, dev)}
    res["seconds"] = time.perf_counter() - t0
    log(f"[precision] phase 13 ran in {res['seconds']:.1f} s")
    return res


# the approximate kNN (phase 14): integer cases held bit for bit, as (label,
# B, N, C, k, queries or None); the production shape's L = 896 leaves a
# short last chunk (7000 = 7 * 896 + 728), as does N = 2000 (L = 1024);
# N = 1000 folds nothing (L = N); k = 16 and 64 take the kernel's 16- and
# 64-slot lists
APPROX_INT_CASES = (
    ("C=4 B=8 N=7000 k=30 (L=896)", B, N, 4, K, None),
    ("C=64 B=8 N=7000 k=30 (L=896)", B, N, 64, K, None),
    ("C=64 B=8 N=1000 k=30 (L=N)", B, 1000, 64, K, None),
    ("C=4 B=8 N=2000 k=30 (L=1024)", B, 2000, 4, K, None),
    ("C=8 B=2 N=4096 k=16 (L=512)", 2, 4096, 8, 16, None),
    ("C=16 B=2 N=5000 k=64 (L=1280)", 2, 5000, 16, 64, None),
    ("C=64 B=2 N=7000 k=30, 1000 queries", 2, N, 64, K, 1000),
)
APPROX_FLOAT_AGREEMENT = 0.9999  # make_blocks' floats: index agreement with the plain version
APPROX_TILE = (300, (120.0, 60.0), 70000)  # the served tile: seed, extent, points
# SHA-256 of the approximate kNN kernel's indices (int32 bytes) on each
# input of approx_digest_inputs, written by its first design (a thread a
# query, sorted register lists) on the H100 by
# scripts/exp_knn_approx_variants.py --parent on that tree: every later
# design must give its bits, floats and non-finite scores included
APPROX_DIGESTS = {
    "blocks C=4": "8864bf693f1982468ac195ebf0a94d965449d5cd8cde16d27d1754cba9f5a6c2",
    "normal C=64": "5d4151c0809f25ffdf56c821be002b58af807b37f82c9dfe1a07ba4b3aa7e8cb",
    "1000 queries C=64": "37c96100c5a2aa3162c9c446d46ce8cc8dd6760ca2d1486185519817055c1156",
    "non-finite C=4": "a11c77b2e30e43b3e2e2ccee333da1a6dcba940cdf7f439d7609bd0642c5c440",
}


def approx_digest_inputs() -> dict:
    """The inputs of :data:`APPROX_DIGESTS`, as numpy ``(x, queries or
    None, k)``: ``make_blocks`` (B, N) at C=4 (the forward's stage 1),
    standard-normal C=64 at (2, 7000), 1000 standard-normal C=64 queries
    against that cloud, and ``make_blocks`` (2, 3000) with some coordinates
    +-inf or NaN (L = 768: -inf, +inf and NaN scores, a NaN at chunk 0
    and at later chunks, queries whose every winner is NaN)."""
    rng = np.random.default_rng(22)
    normal = rng.standard_normal((2, N, 64)).astype(np.float32)
    queries = rng.standard_normal((2, 1000, 64)).astype(np.float32)
    odd = make_blocks(2, 3000, seed=22)
    for value in (np.inf, -np.inf, np.nan):
        at = rng.integers(0, odd.size, 40)
        odd.reshape(-1)[at] = value
    return {"blocks C=4": (make_blocks(B, N, seed=0), None, K),
            "normal C=64": (normal, None, K),
            "1000 queries C=64": (normal, queries, K),
            "non-finite C=4": (odd, None, K)}


def _recall(got, exact) -> float:
    """Mean share of each query's exact k neighbours that ``got`` holds."""
    return (got[..., :, None] == exact[..., None, :]).any(-1).float().mean().item()


def approx_digests_held() -> dict:
    """The approximate kNN kernel's indices on each input of
    :func:`approx_digest_inputs`, held to :data:`APPROX_DIGESTS` (the first
    design's bits, floats and non-finite scores included)."""
    import hashlib

    import torch

    from dgcnn_tpu_torch.kernels.knn_approx import knn_approx

    got = {}
    for label, (x, q, k) in approx_digest_inputs().items():
        out = knn_approx(torch.from_numpy(x).to("cuda"), k,
                         queries=None if q is None else torch.from_numpy(q).to("cuda"))
        got[label] = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        if got[label] != APPROX_DIGESTS[label]:
            raise AssertionError(f"[approx] {label}: SHA-256 {got[label]} is not the first "
                                 f"design's {APPROX_DIGESTS[label]}")
    return got


def phase_approx(tmp: str) -> dict:
    """Phase 14: ``knn_impl="approx"``. (a) The approximate kNN kernel
    (``kernels/knn_approx.py``) against its plain version
    (``ops/knn.py::knn(..., approx=True)``) on the card: bit for bit on the
    integer cases of ``APPROX_INT_CASES``, the first design's bits
    (``APPROX_DIGESTS``, floats and non-finite scores included) with the
    kernel's registers and spills from the build log, at least
    ``APPROX_FLOAT_AGREEMENT`` index agreement on ``make_blocks``' floats,
    and on the approx forward's own three calls (B=8, N=7000, k=30, L=896;
    stage 1 at C=4 on the x-sorted
    blocks, stages 2-3 at C=64) ``_compare``'s float check, each call's
    device-only time (``cuda_ms_many`` of the kernel alone), the wrapper's,
    the plain version's, the bound and the recall against the exact kNN of
    the same call; (b) the approx forward at (2, 5000) against the CPU plain
    forward, probabilities within 1e-3; (c) the launches of one forward and
    of one train step at full width, with the counters reset just before;
    (d) the approx forward's synced and busy times beside the default
    forward's (no claim); (e) one tile served with ``knn_impl="approx"`` and
    the same tile through the CLI's ``--predict --knn_impl approx``, launch
    counts asserted."""
    import torch

    from dgcnn_tpu_torch.__main__ import run as port_cli
    from dgcnn_tpu_torch.kernels.knn_approx import knn_approx, launch_kernel, prepare
    from dgcnn_tpu_torch.models.dgcnn import APPROX_RECALL, DGCNN, DGCNNConfig, init_dgcnn
    from dgcnn_tpu_torch.ops.knn import approx_reduction_size, knn
    from dgcnn_tpu_torch.train.steps import init_train_state, make_train_step
    from scripts.torch_profile_forward import profile

    t_phase = time.perf_counter()
    res = {"int_cases": {}, "calls": {}}
    rng = np.random.default_rng(14)
    # (a) integer cases, bit for bit
    for label, b, n, c, k, m in APPROX_INT_CASES:
        pts = int_cloud(b, n, seed=14) if c == 4 else rng.integers(0, 8, (b, n, c))
        x = torch.from_numpy(np.ascontiguousarray(pts, dtype=np.float32)).to("cuda")
        q = None if m is None else torch.from_numpy(
            rng.integers(0, 8, (b, m, c)).astype(np.float32)).to("cuda")
        got = knn_approx(x, k, APPROX_RECALL, queries=q)
        want = knn(x, k, approx=True, recall_target=APPROX_RECALL, queries=q)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[approx] {label}: kernel != plain on integers "
                                 f"(agreement {(got == want).float().mean().item()})")
        res["int_cases"][label] = {"bins": approx_reduction_size(n, k, APPROX_RECALL),
                                   "bit_equal": True}
        log(f"[approx] {label}: bit for bit, L={res['int_cases'][label]['bins']}")
    res["digests"] = approx_digests_held()
    res["ptxas"] = {label: ptxas_of(fragment) for label, fragment in (
        ("tiled C=64", "knn_approx_tiled_kernelILi64ELi32"),
        ("fused C=4", "knn_approx_fused_kernelILi4ELi32"))}
    log(f"[approx] SHA-256 of the first design's indices held on {list(res['digests'])}; "
        f"ptxas: {res['ptxas']}")

    # the approx forward's own calls at full width
    cfg = DGCNNConfig(k=K, emb_dims=1024, knn_impl="approx")
    weights = init_dgcnn(cfg, torch.Generator().manual_seed(1)).state_dict()
    model = DGCNN(cfg).to("cuda")
    model.load_state_dict(weights)
    x = torch.from_numpy(make_blocks(B, N, seed=0)).to("cuda")
    inputs = []
    real = model._knn

    def record(v, *args, **kwargs):
        inputs.append(v.clone())
        return real(v, *args, **kwargs)

    model._knn = record
    with torch.inference_mode():
        model(x)
    model._knn = real
    width = approx_reduction_size(N, K, APPROX_RECALL)
    for stage, v in zip(("stage 1 C=4", "stage 2 C=64", "stage 3 C=64"), inputs):
        c = v.shape[-1]
        got, want = knn_approx(v, K, APPROX_RECALL), knn(v, K, approx=True)
        exact = knn(v, K)
        torch.cuda.synchronize()
        agree, err = _compare(f"knn_approx {stage}", v, v, got, want, False)
        if c == 4 and agree < APPROX_FLOAT_AGREEMENT:
            raise AssertionError(f"[approx] {stage}: agreement {agree} on make_blocks")
        prepared = prepare(v)
        ms = cuda_ms_many(lambda: launch_kernel(*prepared, K, width))
        b_ms, b_by = bound(4.0 * B * N * (c + 1 + K), 2.0 * B * N * N * c)
        res["calls"][stage] = {
            "agreement": agree, "max_abs_err": err, "ms": ms,
            "wrapper_ms": cuda_ms_many(lambda: knn_approx(v, K, APPROX_RECALL)),
            "plain_ms": cuda_ms(lambda: knn(v, K, approx=True), 3), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "recall": _recall(got, exact),
            "plain_recall": _recall(want, exact), "bins": width}
        log(f"[approx] {stage}: {json.dumps(res['calls'][stage])}")

    # (b) against the CPU plain forward (2, 5000): L = 640
    cpu = DGCNN(cfg)
    cpu.load_state_dict(weights)
    small = torch.from_numpy(make_blocks(2, 5000, seed=2))
    with torch.inference_mode():
        want = torch.softmax(cpu(small), -1)
        got = torch.softmax(model(small.to("cuda")), -1).cpu()
    res["forward_prob_diff"] = (got - want).abs().max().item()
    if not res["forward_prob_diff"] <= 1e-3:
        raise AssertionError(f"[approx] forward vs CPU plain: max prob diff "
                             f"{res['forward_prob_diff']}")
    log(f"[approx] forward (2, 5000) vs CPU plain: max prob diff {res['forward_prob_diff']:.3e}")

    # (c) launches of one forward and one train step, counters reset before
    none = {name: 0 for name in _counters()}
    counters = reset_counters()
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {**none, "knn_approx": 3, "edgeconv_fused_stage": 2, "edgeconv_fused_extrema": 1}
    if launches != want or out.shape != (B, N, 5) or not torch.isfinite(out).all():
        raise AssertionError(f"[approx] forward: launches {launches}, {tuple(out.shape)}")
    res["launches_per_forward"] = launches["knn_approx"]
    state = init_train_state(cfg, seed=2, device="cuda", epochs=30)
    step = make_train_step(cfg)
    labels = torch.from_numpy(rng.integers(0, 5, (B, N))).to("cuda")
    mask = torch.from_numpy((rng.random((B, N)) < 0.7).astype(np.float32)).to("cuda")
    float(step(state, x, labels, mask, None)["loss"])  # warm-up
    counters = reset_counters()
    losses, times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(float(step(state, x, labels, mask, None)["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    per_step = {name: fn.launches / 3 for name, fn in counters.items()}
    want = {**none, "knn_approx": 3, "gather_rows": 3, "scatter_add_rows": 1,
            "scatter_stage_tail_rows": 1}
    if per_step != want or not np.isfinite(losses).all():
        raise AssertionError(f"[approx] train step: launches {per_step}, losses {losses}")
    res["train"] = {"launches_per_step": per_step["knn_approx"], "losses": losses,
                    "step_ms": float(np.median(times))}
    log(f"[approx] train step: {res['train']}")

    # (d) the approx forward beside the default one (unguarded)
    default = DGCNN(DGCNNConfig(k=K, emb_dims=1024)).to("cuda")
    default.load_state_dict(weights)
    res["forward"] = {}
    for name, fn in (("approx", lambda: model(x)), ("default unguarded",
                                                     lambda: default(x, band_mode=0))):
        with torch.inference_mode():
            synced = cuda_ms(fn, 10)
        prof = profile(fn, 10)
        res["forward"][name] = {"synced_ms": synced, "busy_ms": prof["busy_ms_per_forward"],
                                "idle_share": prof["idle_share"],
                                "knn_ms": {g: v["ms"] for g, v in prof["groups"].items()
                                           if g.startswith("knn")}}
        log(f"[approx] forward {name} B={B} N={N}: {json.dumps(res['forward'][name])}")

    # (e) the serving path and the CLI on one tile
    ckpt = os.path.join(tmp, "approx_ckpt")
    write_checkpoint(os.path.join(ckpt, "dgcnn_model.npz"), DGCNNConfig(k=K, emb_dims=1024),
                     seed=0)
    launches, batches = serve_tiles(tmp, "approx", {"tile_a": APPROX_TILE}, model_root=ckpt,
                                    knn_impl="approx")
    nb, fwd = sum(batches.values()), launches["knn_approx"] // 3
    want = {**none, "knn_approx": 3 * fwd, "edgeconv_fused_stage": 2 * fwd,
            "edgeconv_fused_extrema": fwd}
    if fwd < nb or launches != want:
        raise AssertionError(f"[approx] served: launches {launches} for {nb} batches")
    res["serve_launches"] = launches
    tile = os.path.join(tmp, "approx", "landing", "tile_a.las")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        counters = reset_counters()
        port_cli(["--mode", "classifier", "--predict", tile, "--predict_out",
                  os.path.join(tmp, "approx_cli.las"), "--knn_impl", "approx", "--k", str(K),
                  "--num_points", str(N), "--num_features", "4", "--emb_dims", "1024",
                  "--model_root", ckpt, "--exp_name", "approx"])
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    cli = {name: fn.launches for name, fn in counters.items()}
    if cli["knn_approx"] < 3 or cli["knn_approx"] % 3 or any(
            v for name, v in cli.items() if name.startswith("knn") and name != "knn_approx"):
        raise AssertionError(f"[approx] --predict --knn_impl approx: launches {cli}")
    res["cli_launches"] = cli
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[approx] phase 14 ran in {res['seconds']:.1f} s")
    return res


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
        train_configs = phase_train_configs(tmp)
        parallel = phase_parallel(tmp)  # 12d trains on phase 7's rooms
        # on phase 7's rooms and checkpoint
        precision = phase_precision(tmp, l2=fused[1]["l2_gather"])
    with tempfile.TemporaryDirectory() as tmp:
        lifecycle = phase_lifecycle(tmp, smi)
    with tempfile.TemporaryDirectory() as tmp:
        t_wide = time.perf_counter()
        tile, blocks = wide_scene(tmp)
        wide_kernels = phase_wide_kernels(blocks)
        wide_life = phase_wide_lifecycle(tile)
        root = os.path.dirname(os.path.dirname(tile))
        wide_fwd = phase_wide_forward(blocks, {f: os.path.join(root, f"ckpt{f}")
                                               for f in (4, *WIDE)})
        viz = phase_viz(root)
        log(f"[wide] phase 10 ran in {time.perf_counter() - t_wide:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        approx = phase_approx(tmp)
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
    # the TF32 stage (phase 13a), its launches on the serve CLI's tile under
    # --matmul_precision default (phase 13d); cuBLAS's TF32 GEMM on the bare
    # product as a ceiling, the FP32 and bf16 kernels timed beside it
    tf = precision["kernel"]
    kernels.append({
        "name": "edgeconv_fused_stage_tf32", "route": "cuda",
        "source": "dgcnn_tpu_torch/kernels/csrc/edgeconv_fused.cu",
        "replaces": "dgcnn_tpu/kernels/edgeconv_pallas.py:67",
        "launches": precision["cli"]["serve_launches"]["edgeconv_fused_stage_tf32"],
        **{k_: tf[k_] for k_ in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "mode": "tf32_mm (matmul_precision=\"default\")",
        "status": "redesigned (Queue 2 row 2': each W2 fragment read once a unit)",
        **{k_: tf[k_] for k_ in ("bounds_ms", "share_of_bound", "ptxas", "f32_ms", "bf16_ms",
                                 "cublas_tf32_ms")}})
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
    # the approximate kNN (phase 14): the approx forward's stage-2 call at
    # C=64, its stage-1 (C=4) and stage-3 calls beside it; its launches on
    # the served tile
    calls = approx["calls"]
    kernels.append({
        "name": "knn_approx", "route": "cuda",
        "source": "dgcnn_tpu_torch/kernels/csrc/knn_approx.cu",
        "replaces": "dgcnn_tpu/ops/knn.py:99 (jax.lax.approx_max_k: XLA's ApproxTopK)",
        "launches": approx["serve_launches"]["knn_approx"],
        "max_abs_err": max(c["max_abs_err"] for c in calls.values()),
        **{k_: calls["stage 2 C=64"][k_] for k_ in timing},
        "c4": {k_: calls["stage 1 C=4"][k_] for k_ in timing},
        "stage3": {k_: calls["stage 3 C=64"][k_] for k_ in timing},
        "recall": {name: c["recall"] for name, c in calls.items()},
        "ptxas": approx["ptxas"],
        "launches_per_forward": approx["launches_per_forward"],
        "launches_per_train_step": approx["train"]["launches_per_step"]})
    # phase 12: each ring kernel at the ring's shapes, and every row's
    # launches on the parallel paths
    ring_cases = {"knn_exact": {"ring_hop": parallel["ring_knn"]["hops"]["c64"],
                                "ring_hop_c4": parallel["ring_knn"]["hops"]["c4"]},
                  "gather_rows": {"ring": parallel["rows"]["gather_rows"]},
                  "scatter_add_rows": {"ring": parallel["rows"]["scatter_add_rows"]}}
    ring_c4 = parallel["ring_knn"]["cases"]["C=4 float band 1"]["knn_exact_launches"]
    for row in kernels:
        for label, case in ring_cases.get(row["name"], {}).items():
            row[label] = case
            row["max_abs_err"] = max(row["max_abs_err"], case["max_abs_err"])
        row["parallel_launches"] = {
            "ring_knn_c4_band1": ring_c4 if row["name"] == "knn_exact" else 0,
            "whole_predict": parallel["whole_predict"]["predict"]["launches"][row["name"]],
            "sharded_train_step":
                parallel["sharded_train"]["launches_per_step"].get(row["name"], 0)}
    for row in kernels:  # the share of its bound each kernel (and case) reaches
        row.update(wide_kernels.get(row["name"], {}))  # its C=6 and C=9 cases
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["lifecycle_launches"] = lifecycle["launches"][row["name"]]
        row["wide_lifecycle_launches"] = wide_life["launches"][row["name"]]
        row["train_configs_launches_per_step"] = {
            name: c["launches_per_step"][row["name"]]
            for name, c in train_configs["configs"].items()}
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
                    "train": trained, "train_configs": train_configs,
                    "lifecycle": lifecycle, "parallel": parallel, "precision": precision,
                    "approx": approx,
                    "wide": {"kernels": wide_kernels, "forward": wide_fwd,
                             "lifecycle": wide_life, "viz": viz}}))
    log(json.dumps({"kernels": kernels}))
    from dgcnn_tpu_torch.ops.matmul import ROUTES

    log(f"16-bit trunk GEMM routes: {ROUTES}; chip_smoke.py ran in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
