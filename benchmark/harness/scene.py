"""Synthetic airborne-LiDAR blocks and training masks, made from a seed.

Each block is a 30 m x 30 m cut of an ALS scene of ``n`` points: sloped
terrain (0.03 x + 0.02 y), 30% vegetation from 0.8 m up to 12.8 m above
ground (low below 3 m, high above), one 14 m x 14 m roof at 7 m, 3% low
isolated points; labels ground 0, low vegetation 1, high vegetation 2,
roof 3, other 4, so every block holds all five classes. The wide feature
set adds what a scanner writes, raw: uint16 intensity by class (ground
1800, vegetation 900, roofs 2600, sigma 250), return numbers 1-4 on
vegetation (1 elsewhere), uint16 RGB by class (sigma 3000). Each block is
shifted to its own x / y minimum and sorted by x (stable), as the blocked
predict path hands blocks to the model.

The class-balance mask is the reference's ``create_train_mask``
(AHN3-dgcnn ``data.py:80-105``, with the sampled points' own labels).
"""

from __future__ import annotations

import numpy as np

WIDE = ("intensity", "red", "green", "blue", "return_number")


def make_blocks(rng: np.random.Generator, n_blocks: int, n: int,
                features: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """``(points (n_blocks, n, len(features)) float32, labels (n_blocks, n)
    int64)``; ``features`` names the columns (x y z agl and any of
    :data:`WIDE`)."""
    f32 = np.float32
    shape = (n_blocks, n)
    xy = rng.random(shape + (2,), dtype=f32) * f32(30.0)
    ground = f32(0.03) * xy[..., 0] + f32(0.02) * xy[..., 1]
    agl = np.abs(rng.standard_normal(shape, dtype=f32)) * f32(0.05)
    label = np.zeros(shape, np.int64)
    veg = rng.random(shape, dtype=f32) < 0.3
    agl = np.where(veg, rng.random(shape, dtype=f32) * f32(12) + f32(0.8), agl)
    label[veg] = np.where(agl[veg] < 3.0, 1, 2)
    corner = rng.uniform(2.0, 14.0, (n_blocks, 1, 2)).astype(f32)
    roof = ((xy > corner) & (xy < corner + 14)).all(-1) & ~veg
    agl[roof] = f32(7.0) + rng.standard_normal(int(roof.sum()), dtype=f32) * f32(0.03)
    label[roof] = 3
    other = (rng.random(shape, dtype=f32) < 0.03) & ~veg & ~roof
    agl[other] = rng.random(int(other.sum()), dtype=f32) * f32(0.5) + f32(0.2)
    label[other] = 4
    cols = {"x": xy[..., 0], "y": xy[..., 1], "z": ground + agl, "agl": agl}
    if any(f in WIDE for f in features):
        kind = np.select([veg, roof], [1, 2], 0)  # ground, vegetation, roof
        noise = rng.standard_normal(shape + (4,), dtype=f32)
        cols["intensity"] = _u16(np.array([1800, 900, 2600], f32)[kind] + f32(250) * noise[..., 0])
        n_ret = np.where(veg, rng.integers(2, 5, shape), 1)
        cols["return_number"] = np.where(veg, rng.integers(1, n_ret + 1), 1).astype(f32)
        colour = np.array([[30000, 24000, 16000], [14000, 30000, 12000],
                           [42000, 22000, 19000]], f32)[kind]
        for i, name in enumerate(("red", "green", "blue")):
            cols[name] = _u16(colour[..., i] + f32(3000) * noise[..., i + 1])
    order = np.argsort(cols["x"], axis=1, kind="stable")
    pts = np.empty(shape + (len(features),), f32)
    for j, f in enumerate(features):
        pts[..., j] = np.take_along_axis(cols[f], order, axis=1)
    pts[..., 0] -= pts[..., 0].min(axis=1, keepdims=True)
    pts[..., 1] -= pts[..., 1].min(axis=1, keepdims=True)
    return pts, np.take_along_axis(label, order, axis=1)


def _u16(v: np.ndarray) -> np.ndarray:
    """Raw uint16 values, held as float32 (exact below 2^24)."""
    return np.clip(np.rint(v), 0, 65535)


def create_train_mask(rng: np.random.Generator, labels: np.ndarray, num_classes: int,
                      exclude_classes: tuple[int, ...] = ()) -> np.ndarray:
    """The reference's class-balance loss mask: ``m = min(smallest count of a
    considered class, floor(len / num_classes))`` random points of every
    considered class get 1."""
    labels = labels.astype(np.int64).ravel()
    counts = np.bincount(labels, minlength=num_classes)[:num_classes]
    considered = [c for c in range(num_classes) if c not in exclude_classes]
    mask = np.zeros(labels.shape, np.float32)
    if not considered:
        return mask
    m = int(min(min(counts[c] for c in considered), np.floor(len(labels) / num_classes)))
    if m <= 0:
        return mask
    for c in considered:
        idxs = np.flatnonzero(labels == c)
        if len(idxs):
            mask[rng.choice(idxs, size=min(m, len(idxs)), replace=False)] = 1.0
    return mask
