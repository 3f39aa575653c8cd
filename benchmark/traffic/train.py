"""``train``: closed-loop training steps in ``train()``'s own order
(``train/loop.py:274-309``).

Set-up makes a pool of ``pool_batches`` batches from the seed: blocks of
``harness/scene.py`` with their labels and the reference's class-balance
masks. The weights come from the seed on the device; the state is the
port's ``TrainState`` (Adam as ``make_optimizer`` builds it, the dropout
generator on the device); the model, its train step and its guard are
the architecture's (``arch/``). Each pass over the pool (an epoch: the
first in order, later ones shuffled from the seed) goes through
``prefetch_to_device(size=2)`` and ``to_device``, and re-arms the guard
(DGCNN: the recall guard's ``BandGuardScheduler``). Each step takes
``next_mode()``, calls the step (DGCNN: the guarded ``make_train_step``
step), adds the confusion matrix on the device and makes the loop's one
host read: the loss, and the trip flag with it on a guarded step.

Set-up drives this one state through its first ``setup_steps`` steps, the
window's own call and feed on the pool's first batches, and records what
the check follows: the losses, the neighbour indices and the first Adam
moment of step 1, the parameters' change after step 3. The window then
trains the same state on. It counts the points of the steps it completed.
"""

from __future__ import annotations

import math
import time

import numpy as np

STEPS_CHECKED = 3


def run(ctx) -> dict:
    import torch

    from dgcnn_tpu_torch.data.prefetch import prefetch_to_device, to_device
    from dgcnn_tpu_torch.train.steps import TrainState, make_optimizer
    from harness import scene
    from harness.core import generator

    cfg_file, p, dev = ctx["config"], ctx["params"], ctx["device"]
    tr = cfg_file["train"]
    b, n_pts, seed = cfg_file["batch_size"], cfg_file["num_points"], ctx["seed"]

    phases = {"start": time.perf_counter() - ctx["t_start"]}
    t = time.perf_counter()
    judge_train = ctx["arch"].judge_train
    pieces = ctx["arch"].Pieces(cfg_file, ctx.get("overrides", {}), seed, dev)
    weights, model, tap = pieces.weights, pieces.module, pieces.tap
    opt, lr_at = make_optimizer(
        model.parameters(), lr=tr["lr"], momentum=tr["momentum"],
        weight_decay=tr["weight_decay"], scheduler=tr["scheduler"], epochs=tr["epochs"],
        steps_per_epoch=p["pool_batches"])
    dropout_seed = int(np.random.default_rng([seed, 4]).integers(0, 2**62))
    state = TrainState(model=model, optimizer=opt, lr_at=lr_at,
                       rng=np.random.default_rng([seed, 3]).integers(0, 2**32, 2, dtype=np.uint32),
                       generator=generator(dropout_seed, dev))
    train_step = pieces.train_step()
    fault = ctx.get("fault")
    if fault is not None:
        train_step = fault.plant_train(train_step, state)

    rng = np.random.default_rng([seed, 1])
    pts, labels = scene.make_blocks(rng, p["pool_batches"] * b, n_pts, cfg_file["features"])
    masks = np.stack([scene.create_train_mask(rng, lab, pieces.num_classes) for lab in labels])
    pool = [(pts[i * b:(i + 1) * b], labels[i * b:(i + 1) * b], masks[i * b:(i + 1) * b])
            for i in range(p["pool_batches"])]
    phases["weights_and_pool"] = time.perf_counter() - t
    spans = ctx["spans"]
    counts = {"steps": 0, "trips": 0, "failed": 0, "guarded": 0}
    cm_dev = torch.zeros((pieces.num_classes, pieces.num_classes), device=dev)
    passes = [0]

    def feed():
        while True:
            order = (np.arange(len(pool)) if passes[0] == 0
                     else np.random.default_rng([seed, 5, passes[0]]).permutation(len(pool)))
            passes[0] += 1
            pieces.rearm()
            yield from prefetch_to_device(
                (pool[i] for i in order), size=2,
                transfer=lambda bt: (bt, to_device(bt, dev)))

    batches = feed()

    def step() -> float:
        nonlocal cm_dev
        with spans("input_wait"):
            _, (x, y, m) = next(batches)
        with spans("step"):
            mode, guarded = pieces.next_mode()
            metrics = train_step(state, x, y, m, *mode)
        with spans("loss_read"):
            if guarded:
                loss, flag = torch.stack(
                    [metrics["loss"], metrics["band_tripped"].float()]).tolist()
                pieces.observe(bool(flag))
                counts["trips"] += int(flag)
                counts["guarded"] += 1
            else:
                loss = float(metrics["loss"])
        cm_dev += metrics["confusion"]
        counts["steps"] += 1
        counts["failed"] += not math.isfinite(loss)
        return loss

    # set-up: the state's first steps, recorded for the check
    beta1 = opt.param_groups[0]["betas"][0]
    names = [n for n, _ in model.named_parameters()]
    losses, idxs, grad_norms, change_norms = [], [], {}, {}
    t = time.perf_counter()
    for i in range(p["setup_steps"]):
        tap.armed = i < STEPS_CHECKED
        losses.append(step())
        if i < STEPS_CHECKED:
            idxs.append([t.cpu().numpy() for t in tap.take()])
        if i == 0:
            moments = torch.stack([opt.state[q].get("exp_avg", torch.zeros_like(q)).norm()
                                   for q in model.parameters()])
            grad_norms = dict(zip(names, (moments / (1 - beta1)).tolist()))
        if i == STEPS_CHECKED - 1:
            change = torch.stack([(q.detach() - weights[n]).norm()
                                  for n, q in model.named_parameters()])
            change_norms = dict(zip(names, change.tolist()))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    phases["first_steps"] = time.perf_counter() - t
    for key in counts:
        counts[key] = 0
    spans.seconds.clear()

    setup_s = time.perf_counter() - ctx["t_start"]
    t_win = time.perf_counter()
    deadline = t_win + ctx["seconds"]
    while time.perf_counter() < deadline:
        step()
    window_s = time.perf_counter() - t_win
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window = dict(counts, window_s=window_s, points=counts["steps"] * b * n_pts,
                  host_ms={k: spans.mean_ms(k) for k in spans.seconds})

    traced = None
    if ctx["trace"]:
        from harness.trace import profiled

        before = counts["steps"]
        with profiled(spans, ctx["kernel_groups"]) as traced:
            for _ in range(p["trace_steps"]):
                step()
        traced["steps"] = counts["steps"] - before

    program = {"losses": losses[:STEPS_CHECKED], "grad_norms": grad_norms,
               "change_norms": change_norms}
    checked = pool[:STEPS_CHECKED]
    return {
        "setup_s": setup_s,
        "setup_phases": phases,
        "attempted": window["steps"],
        "failed": window["failed"],
        "memory_peak_bytes": memory_peak,
        "end_to_end": {
            "train_pts_per_s": window["points"] / window_s,
            "peak_gb": memory_peak / 1e9,
            "setup_s": setup_s,
        },
        "obs": {"window": window, "trace": traced, "batch": b, "points": n_pts},
        "judge": lambda: judge_train(weights, checked, idxs, dropout_seed, program, cfg_file,
                                     dev),
    }
