"""The throwaway architecture's least work, copied in as ``work/toy.py``:
one kernel family, ``pointwise``, the two per-point products."""

from __future__ import annotations

F32 = 4
KERNEL_GROUPS = (("toy_pointwise", "pointwise"),)


def shapes(cfg: dict, batch: int, points: int) -> dict:
    m = cfg["model"]
    return {"B": batch, "N": points, "F": m["num_features"], "H": m["hidden"],
            "C": m["num_classes"]}


def forward_flops(s: dict) -> float:
    return 2.0 * s["B"] * s["N"] * (s["F"] * s["H"] + s["H"] * s["C"])


def train_flops(s: dict) -> float:
    # the forward and both cotangents of the second product, the first's
    # weight cotangent only (the points need none)
    return forward_flops(s) + 2.0 * s["B"] * s["N"] * (s["F"] * s["H"] + 2 * s["H"] * s["C"])


def _pointwise(s: dict, flops: float) -> dict:
    return {"flops": flops, "bytes": F32 * s["B"] * s["N"] * (s["F"] + s["C"])}


def inference_sites(s: dict) -> dict:
    return {"pointwise": (_pointwise(s, forward_flops(s)), 1)}


def training_sites(s: dict) -> dict:
    return {"pointwise": (_pointwise(s, train_flops(s)), 1)}
