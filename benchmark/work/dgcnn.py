"""The least work of DGCNN segmentation at each call site, from the
configuration and the shapes alone.

Counts the operations (2 per multiply-add) and the bytes (each input read
once, each output written once, 4-byte floats and indices, 1-byte argmax
slots) that the model's equations need, never what a kernel of the program
does, so no rewrite of a kernel can read above its bound.

Per batch of B clouds of N points, F input features, k neighbours, the
64-channel stages, an emb-channel trunk and C classes:

* kNN, for each of the three graphs (widths F, 64, 64): all pairs of the
  exact kNN, 2 B N^2 c operations; the points read and the indices written,
  4 B N (c + k) bytes. Guard probes and repairs are not model work.
* EdgeConv: the first conv of a stage is linear in x_j and x_i, so its two
  products count per point (2 x 2 B N c 64); a product after a nonlinearity
  counts per edge (conv2, conv4: 2 B N k 64 64); stage 3's single conv
  counts per point, since its max runs over a per-point product.
* The fused stage call (stages 1 and 2) gets both point products and does
  the per-edge conv and the max: 2 B N k 64 64 operations; it reads the two
  (B, N, 64) tables, the indices and writes (B, N, 64).
* The extrema call (stage 3) gets both point products and takes the max
  and min over k: no products; 4 B N (3 x 64 + k) bytes.
* The trunk: conv6 (192 -> emb), conv7 (emb + 192 -> 512), conv8
  (512 -> 256), conv9 (256 -> C) at B N rows each.
* Training: the forward's count plus twice the products of the layers that
  are differentiated (a weight's and an input's cotangent each cost a
  product the size of the forward's), except the products of the raw input
  points, whose input needs no cotangent (once).
* Training rows: three gathers a step, of the raw points (width F: the
  points' cotangent is never needed, so stage 1 needs no scatter) and of
  stage 2's and stage 3's 64-channel tables; each reads its (B, N, c)
  table and the indices and writes (B, N, k, c). One row scatter (stage 2's
  backward) reads (B, N, k, 64) and the indices and writes (B, N, 64); the
  stage-3 tail scatter reads two (B, N, 64) tables, the 1-byte argmax slots
  and the indices and writes the (B, N, 64) sums and the (B, N) counts.

At the production shapes (B=8, N=7000, k=30, emb 1024, C=5), F=4: kNN
103.49 GFLOP a batch, EdgeConv 29.42, trunk 106.57, forward 239.48, train
step 511.40; F=9: kNN 107.41, EdgeConv 29.49, forward 243.47, train step
515.47 (``tests/test_benchmark_harness.py`` holds these).
"""

from __future__ import annotations

STAGE_C = 64  # the EdgeConv stages' width
F32 = 4


def shapes(cfg: dict, batch: int, points: int) -> dict:
    """The sizes the counts need, from a configuration file's model block."""
    m = cfg["model"]
    return {"B": batch, "N": points, "F": m["num_features"], "k": m["k"],
            "emb": m["emb_dims"], "C": m["num_classes"]}


def knn(s: dict) -> dict:
    """The three graphs of one batch: operations and bytes."""
    b, n, k = s["B"], s["N"], s["k"]
    widths = (s["F"], STAGE_C, STAGE_C)
    return {"flops": sum(2.0 * b * n * n * c for c in widths),
            "bytes": sum(F32 * b * n * (c + k) for c in widths)}


def edgeconv_products(s: dict) -> dict:
    """The stages' products of one batch, by conv: operations."""
    b, n, k, f, c = s["B"], s["N"], s["k"], s["F"], STAGE_C
    return {
        "conv1": 2.0 * 2 * b * n * f * c,  # per point: x W_d and x (W_x - W_d)
        "conv2": 2.0 * b * n * k * c * c,  # per edge
        "conv3": 2.0 * 2 * b * n * c * c,
        "conv4": 2.0 * b * n * k * c * c,
        "conv5": 2.0 * 2 * b * n * c * c,  # stage 3: per point
    }


def trunk_products(s: dict) -> dict:
    b, n, emb = s["B"], s["N"], s["emb"]
    return {
        "conv6": 2.0 * b * n * 3 * STAGE_C * emb,
        "conv7": 2.0 * b * n * (emb + 3 * STAGE_C) * 512,
        "conv8": 2.0 * b * n * 512 * 256,
        "conv9": 2.0 * b * n * 256 * s["C"],
    }


def forward_flops(s: dict) -> float:
    """One batch's forward: kNN, EdgeConv and trunk."""
    return (knn(s)["flops"] + sum(edgeconv_products(s).values())
            + sum(trunk_products(s).values()))


def train_flops(s: dict) -> float:
    """One train step: the forward, then each product's two cotangents
    (the raw points' conv1 products only the weight's)."""
    prods = {**edgeconv_products(s), **trunk_products(s)}
    backward = sum(2.0 * v for v in prods.values()) - prods["conv1"]
    return forward_flops(s) + backward


def stage_call(s: dict) -> dict:
    """One fused stage call (stage 1 or 2)."""
    b, n, k, c = s["B"], s["N"], s["k"], STAGE_C
    return {"flops": 2.0 * b * n * k * c * c,
            "bytes": F32 * (b * n * (3 * c + k) + c * c + 4 * c)}


def extrema_call(s: dict) -> dict:
    """The stage-3 extrema call."""
    b, n, k, c = s["B"], s["N"], s["k"], STAGE_C
    return {"flops": 0.0, "bytes": F32 * (b * n * (3 * c + k) + 3 * c)}


def gather_calls(s: dict) -> dict:
    """The step's three gathers (widths F, 64, 64), summed."""
    b, n, k = s["B"], s["N"], s["k"]
    return {"flops": 0.0,
            "bytes": sum(F32 * b * n * (c + k + k * c) for c in (s["F"], STAGE_C, STAGE_C))}


def scatter_call(s: dict) -> dict:
    b, n, k, c = s["B"], s["N"], s["k"], STAGE_C
    return {"flops": 0.0, "bytes": F32 * b * n * (k * c + k + c)}


def tail_call(s: dict) -> dict:
    b, n, k, c = s["B"], s["N"], s["k"], STAGE_C
    return {"flops": 0.0, "bytes": b * n * (F32 * (2 * c + k + c + 1) + c)}


# call sites a batch or a step has, by kernel family: (work, calls)
def inference_sites(s: dict) -> dict:
    return {"knn": (knn(s), 1), "stage": (stage_call(s), 2), "extrema": (extrema_call(s), 1)}


def training_sites(s: dict) -> dict:
    return {"knn": (knn(s), 1), "gather": (gather_calls(s), 1), "scatter": (scatter_call(s), 1),
            "tail": (tail_call(s), 1)}
