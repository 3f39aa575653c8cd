"""Segmentation metrics from a confusion matrix.

Counterpart of ``dgcnn_tpu/ops/metrics.py``: the train and eval steps
accumulate a (C, C) confusion matrix on the device, and accuracy,
balanced accuracy and IoU are derived from it at logging time (host
numpy or tensors alike). :func:`calculate_sem_iou` is a copy of the
original's host-side per-room IoU (evaluation).
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, true: torch.Tensor, num_classes: int,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """Counts ``[true, pred]``, optionally point-weighted; (C, C) float32.
    Out-of-range labels on either side (e.g. the UNCLASSIFIED=31 marker)
    are dropped. Built with ``index_add_`` into C*C bins, which needs no
    host read (``torch.bincount`` reads the maximum on the host)."""
    pred = pred.reshape(-1).long()
    true = true.reshape(-1).long()
    valid = (pred >= 0) & (pred < num_classes) & (true >= 0) & (true < num_classes)
    w = valid.to(torch.float32)
    if weights is not None:
        w = w * weights.reshape(-1).to(torch.float32)
    flat = torch.where(valid, true * num_classes + pred, 0)
    counts = torch.zeros(num_classes * num_classes, dtype=torch.float32, device=w.device)
    counts.index_add_(0, flat, w)
    return counts.reshape(num_classes, num_classes)


def accuracy_from_confusion(cm) -> torch.Tensor:
    """Overall accuracy = trace / total."""
    cm = torch.as_tensor(cm, dtype=torch.float64)
    return torch.trace(cm) / cm.sum().clamp_min(1.0)


def balanced_accuracy_from_confusion(cm) -> torch.Tensor:
    """Mean per-class recall over the classes present in the ground truth
    (``sklearn.metrics.balanced_accuracy_score``)."""
    cm = torch.as_tensor(cm, dtype=torch.float64)
    support = cm.sum(dim=1)
    recall = torch.diagonal(cm) / support.clamp_min(1.0)
    present = (support > 0).to(recall.dtype)
    return (recall * present).sum() / present.sum().clamp_min(1.0)


def iou_from_confusion(cm) -> torch.Tensor:
    """Per-class intersection over union (NaN where a class is in neither
    prediction nor truth)."""
    cm = torch.as_tensor(cm, dtype=torch.float64)
    inter = torch.diagonal(cm)
    union = cm.sum(dim=0) + cm.sum(dim=1) - inter
    return inter / union


def calculate_sem_iou(pred_rooms, true_rooms, num_classes: int) -> np.ndarray:
    """Host-side per-class IoU over a list of rooms: sequences of per-room
    prediction and ground-truth label arrays (NaN where a class is in
    neither)."""
    inter = np.zeros(num_classes, np.float64)
    union = np.zeros(num_classes, np.float64)
    for pred, true in zip(pred_rooms, true_rooms):
        pred = np.asarray(pred)
        true = np.asarray(true)
        for c in range(num_classes):
            p = pred == c
            t = true == c
            inter[c] += np.sum(p & t)
            union[c] += np.sum(p | t)
    with np.errstate(divide="ignore", invalid="ignore"):
        return inter / union
