"""The comparisons that decide ``correct``, against the plain reference.

The program's kNN is approximate by design (the banded kNN of the feature
stages is defended by a sampled recall guard; stage 1's FP32 scores part
from exact ones on near-ties), and one neighbour changed at one point moves
the global max, and with it every point's probabilities, by more than a
lower precision of the products does. So the reference follows the
program's own graphs, which the run records from the timed path, and the
kNN is checked on its own: every stage's neighbour lists against the exact
kNN of the reference's own features at that stage.

Numbers of a ``tiles`` cell, over a sample of the window's batches:

* ``logit_gap``: the largest |l - l_ref| over a sampled block's real points
  and classes, over the block's largest |l_ref|, by the worst block;
* ``prob_gap``: the largest |p - p_ref| over the sampled real points and
  the classes (reported; at F=9 the random weights saturate the softmax,
  so it swings with the few points near a class boundary);
* ``label_rule``: the share of sampled real points whose served label
  differs from the serving rule (the class, or 31 below the confidence
  limit) applied to the served probabilities: the threshold on its own;
* ``knn_miss``: the largest share, over sampled blocks and the three
  stages, of the program's neighbour entries that are not among the exact
  k nearest (``dgcnn_ref.knn_miss_share``).

Numbers of a ``train`` cell, over the first three steps of the state the
window goes on to train:

* ``loss_gap.1`` - ``loss_gap.3``: each step's relative gap of the loss;
* ``grad_gap``: the first gradient as the optimizer took it (the program's
  from its first Adam moment, m_1 / (1 - beta1)), by the worst leaf: the
  gap of the two norms over the larger of the reference leaf's norm and the
  median leaf's;
* ``change_gap``: the norm of each leaf's change over the three steps, by
  the worst leaf, likewise;
* ``knn_miss``: as above, over the first step's graphs: from the second
  step on the reference's weights part from the program's by Adam's
  first, sign-like update of near-nought gradient entries, and the graphs
  of their features part on near-ties; the reference follows the
  program's graphs there.

Leaves whose reference gradient is below a thousandth of the median leaf's
move under Adam by round-off alone: they are left out of the two leaf
numbers (none is, at these configurations' weights).
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from dgcnn_ref import (
    Adam,
    _bn_eval,
    _bn_train,
    _edge,
    forward,
    knn_miss_share,
    lrelu,
    serve_probs,
    smoothed_ce,
    strict_fp32,
)

NOUGHT_GRAD = 1e-3  # a leaf below this share of the median leaf's gradient


def _stage_inputs(w, x, idxs, bn=_bn_eval):
    """The reference's features at each stage's kNN: the points, then
    stages 1-2's outputs over the graphs ``idxs`` (BN ``bn``)."""
    feats = [x]
    v = x
    for idx, convs in ((idxs[0], (1, 2)), (idxs[1], (3, 4))):
        h = _edge(v, idx)
        for c in convs:
            h = lrelu(bn(h @ w[f"conv{c}.w"], w, f"bn{c}"))
        v = h.max(dim=2).values
        feats.append(v)
    return feats


def judge_tiles(samples: list, w: dict, k: int, min_confidence: float, device) -> dict:
    """``samples``: dicts of ``points`` (b, N, F) float32, ``probs`` and
    ``logits`` (b, N, C), ``labels`` (b, N) and ``idx`` (three (b, N, k)) as
    the program served its real blocks. Returns the numbers (inf where a
    sample cannot be followed)."""
    strict_fp32()
    failed = dict.fromkeys(("logit_gap", "prob_gap", "label_rule", "knn_miss"), math.inf)
    logit_gap = prob_gap = miss = 0.0
    rule_mismatch = n_pts = 0
    with torch.no_grad():
        for s in samples:
            pts = torch.as_tensor(s["points"], device=device)
            idx = [torch.as_tensor(np.asarray(i), device=device).long() for i in s["idx"]]
            b, n = pts.shape[:2]
            if any(tuple(i.shape) != (b, n, k) for i in idx) or s["logits"].shape[:2] != (b, n):
                return failed
            if any(int(i.min()) < 0 or int(i.max()) >= n for i in idx):
                return failed
            for j in range(b):  # a cloud at a time: eval BN couples no clouds
                one = [i[j:j + 1] for i in idx]
                ref = forward(w, pts[j:j + 1], one)[0]
                got = torch.as_tensor(s["logits"][j], device=device)
                scale = float(ref.abs().max().clamp_min(1e-30))
                logit_gap = max(logit_gap, float((got - ref).abs().max()) / scale)
                probs = torch.as_tensor(s["probs"][j], device=device)
                prob_gap = max(prob_gap, float((probs - torch.softmax(ref, -1)).abs().max()))
                # the served labels against the rule applied to the served
                # probabilities: the threshold step on its own
                _, rule = serve_probs(probs, min_confidence)
                served = torch.as_tensor(s["labels"][j], device=device).long()
                rule_mismatch += int((served != rule).sum())
                n_pts += n
                for feat, i in zip(_stage_inputs(w, pts[j:j + 1], one), one):
                    miss = max(miss, knn_miss_share(feat[0], i[0], k))
    if not n_pts:
        return failed
    return {"logit_gap": logit_gap, "prob_gap": prob_gap, "label_rule": rule_mismatch / n_pts,
            "knn_miss": miss}


def keep_masks(seed: int, shape: tuple, p: float, steps: int, device) -> list:
    """The dropout keep masks of the first ``steps`` steps as the
    configuration draws them: ``uniform < 1 - p`` from a generator on the
    device seeded with ``seed``, one (B, N, 256) draw a step."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    return [torch.rand(shape, generator=g, device=device) < 1.0 - p for _ in range(steps)]


def leaf_gap(got: dict, want: dict, keep: list) -> float:
    """The worst leaf's |‖got‖ - ‖want‖| over max(‖want‖, the median leaf's
    ‖want‖), over the leaves ``keep``."""
    med = statistics.median(want[n] for n in keep)
    return max(abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in keep)


def judge_train(w0: dict, batches: list, idxs: list, keep_masks: list, program: dict,
                cfg: dict, device) -> dict:
    """Follow the program's first three steps: ``batches`` of (points,
    labels, mask), ``idxs`` the program's three graphs of each step,
    ``keep_masks`` the dropout keep masks the configuration draws, and the
    program's readings ``program``: ``losses``, ``grad_norms`` (leaf ->
    norm) and ``change_norms``."""
    strict_fp32()
    tr = cfg["train"]
    params = {n: t.detach().clone().to(device).requires_grad_(True)
              for n, t in w0.items() if not n.endswith((".mean", ".var"))}
    opt = Adam(params, lr=tr["lr"], weight_decay=tr["weight_decay"])
    losses, grad_norms, miss = [], None, 0.0
    for step, ((pts, labels, mask), idx, keep) in enumerate(zip(batches, idxs, keep_masks)):
        pts = torch.as_tensor(pts, device=device)
        idx = [torch.as_tensor(np.asarray(i), device=device).long() for i in idx]
        if any(tuple(i.shape) != tuple(pts.shape[:2]) + (cfg["model"]["k"],) for i in idx):
            return {n: math.inf for n in ("loss_gap.1", "grad_gap", "change_gap", "knn_miss")}
        if step == 0:  # the one step whose weights both sides share exactly
            with torch.no_grad():
                miss = _train_knn_miss(params, pts, idx, cfg["model"]["k"])
        logits = forward(params, pts, idx, train=True, keep=keep.to(device),
                         dropout=cfg["model"]["dropout"])
        loss = smoothed_ce(logits, torch.as_tensor(labels, device=device),
                           torch.as_tensor(mask, device=device))
        loss.backward()
        losses.append(loss.item())
        taken = opt.step()
        if step == 0:
            grad_norms = {n: float(g.norm()) for n, g in taken.items()}
    change = {n: float((p.detach() - w0[n].to(device)).norm()) for n, p in params.items()}
    med = statistics.median(grad_norms.values())
    keep_leaves = [n for n in params if grad_norms[n] >= NOUGHT_GRAD * med]
    gaps = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
            for a, b in zip(program["losses"], losses)]
    gaps += [math.inf] * (len(losses) - len(gaps))
    return {**{f"loss_gap.{i + 1}": g for i, g in enumerate(gaps)},
            "grad_gap": leaf_gap(program["grad_norms"], grad_norms, keep_leaves),
            "change_gap": leaf_gap(program["change_norms"], change, keep_leaves),
            "knn_miss": miss}


def _train_knn_miss(w, pts, idx, k) -> float:
    """The kNN check of a training step's graphs: the exact kNN of the
    points, and of stages 1-2's outputs under the batch's BN statistics, at
    the reference's weights of that step."""
    feats = _stage_inputs(w, pts, idx, bn=_bn_train)
    return max(knn_miss_share(f[j], i[j], k)
               for f, i in zip(feats, idx) for j in range(pts.shape[0]))
