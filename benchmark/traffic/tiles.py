"""``tiles``: serving tiles, one at a time (a closed loop of one client), as
``serve_directory`` hands them to the blocked ``predict()``.

Set-up makes a pool of ``pool_blocks`` 30 m blocks from the seed
(``harness/scene.py``) and the tile schedule: cycles of ``cycle`` tiles
whose block counts are the same stratified log-uniform draw over
[``min_blocks``, ``max_blocks``] in every cycle and every seed, in an order
and with blocks drawn from the seed. Each tile follows ``predict()``'s
dispatch loop (``eval/predict.py:317-358``) with the port's own pieces and
the architecture's (``arch/``): a fresh tile step (DGCNN: the guarded
step and its ``BandGuardScheduler``), batches of ``batch_size`` blocks
through ``assemble_batch`` (the last padded by repeating the tile's last
block), H2D, up to ``in_flight`` batches queued before the host drains
labels, then the re-run of the dispatches the tile names as suspect
(DGCNN: ``suspect_dispatches()`` at ``band_mode=2``).

Tile latency runs from the tile's start to its last label on the host.
Only real, unpadded block points count as classified. The window closes
with the first tile that ends past ``--seconds``.
"""

from __future__ import annotations

import time

import numpy as np

UNCLASSIFIED = 31


def schedule(rng: np.random.Generator, p: dict, n_tiles: int) -> list[np.ndarray]:
    """The block ids of ``n_tiles`` tiles."""
    lo, hi, cycle = np.log(p["min_blocks"]), np.log(p["max_blocks"]), p["cycle"]
    sizes = np.rint(np.exp(lo + (np.arange(cycle) + 0.5) / cycle * (hi - lo))).astype(int)
    tiles = []
    while len(tiles) < n_tiles:
        for size in rng.permutation(sizes):
            tiles.append(rng.choice(p["pool_blocks"], size=int(size), replace=False))
    return tiles[:n_tiles]


def run(ctx) -> dict:
    import torch

    from dgcnn_tpu_torch.eval.predict import assemble_batch
    from harness import scene

    cfg_file, p, dev = ctx["config"], ctx["params"], ctx["device"]
    batch, conf = cfg_file["batch_size"], cfg_file["min_class_confidence"]
    n_pts = cfg_file["num_points"]
    seed = ctx["seed"]

    phases = {"start": time.perf_counter() - ctx["t_start"]}
    t = time.perf_counter()
    judge_tiles = ctx["arch"].judge_tiles
    pieces = ctx["arch"].Pieces(cfg_file, ctx.get("overrides", {}), seed, dev)
    weights, tap = pieces.weights, pieces.tap
    fault = ctx.get("fault")
    if fault is not None:
        fault.plant_tiles(pieces.module)
    rng = np.random.default_rng([seed, 1])
    pool, _ = scene.make_blocks(rng, p["pool_blocks"], n_pts, cfg_file["features"])
    data = pool.reshape(-1, pool.shape[-1])
    block_rows = np.arange(len(data)).reshape(p["pool_blocks"], n_pts)
    cols = list(range(pool.shape[-1]))
    tiles = schedule(rng, p, p["max_tiles"])
    phases["weights_and_pool"] = time.perf_counter() - t
    srng = np.random.default_rng([seed, 2])
    sampled = {int(t): int(srng.integers(0, -(-len(tiles[t]) // batch)))
               for t in srng.choice(p["sample_range"], p["sample_tiles"], replace=False)}
    spans = ctx["spans"]
    pieces.serve(conf, UNCLASSIFIED)
    samples: list = []
    counts = {"tiles": 0, "tripped": 0, "blocks": 0, "dispatches": 0, "reruns": 0}
    latencies: list[float] = []

    def serve(ids: np.ndarray, sample_batch: int | None) -> None:
        t0 = time.perf_counter()
        with spans("tile_start"):
            tile = pieces.tile()
        rows = block_rows[ids]
        n_blocks = len(rows)
        all_pred = np.zeros((n_blocks, n_pts), np.int32)
        in_flight: list = []
        kept: dict = {}

        def assemble(start):
            chunk = assemble_batch(data, rows[start:start + batch], cols)
            nreal = len(chunk)
            if nreal < batch:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch - nreal, 0)])
            return torch.from_numpy(chunk).to(dev), nreal

        def drain_one():
            bi, pred, nreal = in_flight.pop(0)
            with spans("drain"):
                all_pred[bi * batch: bi * batch + nreal] = pred.cpu().numpy()[:nreal]
            if bi in kept:
                kept[bi] = [t.cpu() for t in kept[bi]]

        for bi, start in enumerate(range(0, n_blocks, batch)):
            with spans("dispatch"):
                tap.armed = bi == sample_batch
                points, nreal = assemble(start)
                pred, probs, logits = tile.step(points)
            counts["dispatches"] += 1
            if tap.armed:
                kept[bi] = [probs, logits, *tap.take()]
            in_flight.append((bi, pred, nreal))
            if len(in_flight) > p["in_flight"]:
                drain_one()
        while in_flight:
            drain_one()
        with spans("repair"):
            redo = tile.suspects()
            for bi in redo:
                tap.armed = bi == sample_batch
                points, nreal = assemble(bi * batch)
                pred, probs, logits = tile.rerun(points)
                if tap.armed:
                    kept[bi] = [t.cpu() for t in (probs, logits, *tap.take())]
                all_pred[bi * batch: bi * batch + nreal] = pred.cpu().numpy()[:nreal]
        latencies.append(time.perf_counter() - t0)
        counts["tiles"] += 1
        counts["tripped"] += tile.tripped
        counts["blocks"] += n_blocks
        counts["reruns"] += len(redo)
        for bi, (probs, logits, *idx) in kept.items():
            lo, nreal = bi * batch, min(batch, n_blocks - bi * batch)
            samples.append({"points": pool[ids[lo:lo + nreal]],
                            "probs": probs.numpy()[:nreal],
                            "logits": logits.numpy()[:nreal],
                            "labels": all_pred[lo:lo + nreal].copy(),
                            "idx": [i.numpy()[:nreal] for i in idx]})

    # warm-up: the cell's shapes on every route (DGCNN: guarded, unguarded,
    # the re-run's band_mode=2), a padded batch; not in the window
    t = time.perf_counter()
    for ids in (np.arange(9 * batch), np.arange(batch + 3)):
        serve(ids % p["pool_blocks"], None)
    pieces.warm_rerun(torch.from_numpy(pool[:batch]).to(dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phases["warmup"] = time.perf_counter() - t
    for key in counts:
        counts[key] = 0
    latencies.clear()
    spans.seconds.clear()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    setup_s = time.perf_counter() - ctx["t_start"]
    t_win = time.perf_counter()
    deadline = t_win + ctx["seconds"]
    nxt = 0
    while time.perf_counter() < deadline and nxt < len(tiles):
        serve(tiles[nxt], sampled.get(nxt))
        nxt += 1
    window_s = time.perf_counter() - t_win
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    real_points = counts["blocks"] * n_pts
    window = dict(counts, window_s=window_s, real_points=real_points,
                  host_ms={k: spans.mean_ms(k) for k in spans.seconds})

    traced = None
    if ctx["trace"]:
        from harness.trace import profiled

        before = dict(counts)
        with profiled(spans, ctx["kernel_groups"]) as traced:
            for t in range(nxt, min(nxt + p["trace_tiles"], len(tiles))):
                serve(tiles[t], None)
        traced["dispatches"] = counts["dispatches"] - before["dispatches"] \
            + counts["reruns"] - before["reruns"]

    del pieces, tap
    lat_ms = np.asarray(latencies[:window["tiles"]]) * 1e3
    return {
        "setup_s": setup_s,
        "setup_phases": phases,
        "attempted": window["tiles"],
        "failed": 0,
        "memory_peak_bytes": memory_peak,
        "end_to_end": {
            "infer_pts_per_s": real_points / window_s,
            "tile_p95_ms": float(np.percentile(lat_ms, 95)) if len(lat_ms) else float("nan"),
            "peak_gb": memory_peak / 1e9,
            "setup_s": setup_s,
        },
        "obs": {"window": window, "trace": traced, "batch": batch, "points": n_pts},
        "judge": lambda: judge_tiles(samples, weights, cfg_file, dev),
    }
