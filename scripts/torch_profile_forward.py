"""Where the port's forward, or its train step, spends device time on one
GPU (torch.profiler).

    python scripts/torch_profile_forward.py [--reps 10] [--train]
        [--knn_impl pallas|pallas_packed|approx]
        [--compute_dtype bfloat16|float16|float32]
        [--matmul_precision default|high|highest] [--remat off|selective|full]

Profiles ``reps`` forwards of the production batch (B=8, N=7000, k=30,
emb 1024, x-sorted ``make_blocks``) in three configurations: the default
(``auto``, bands 2048/4096) on a guarded dispatch (``band_mode=1``) and on
an unguarded one (``band_mode=0``), and the capped-only path. For each it
prints the device time per forward by kernel group, the launch count per
forward, the launches that did no work (a predicate read False: a branch
not taken), and the device's idle share of the window (1 - union of
kernel intervals / wall time between the first and last kernel). Ends
with one JSON line of the same numbers. Needs a CUDA device.

``--train`` profiles ``reps`` train steps of the production configuration
instead (B=8, N=7000, k=30, emb 1024, dropout 0.5, Adam, the default
bands): a guarded step (``band_mode=1``) and an unguarded one
(``band_mode=0``), each with the loop's ``float(loss)`` read, on one fixed
batch of ``make_blocks`` points with seeded labels and a 0.7 mask.

``--knn_impl pallas`` (the parity mode: the exact banded kNN),
``pallas_packed`` (the flat packed kNN) or ``approx`` (the approximate kNN
kernel) profiles that configuration instead: its forward, or with ``--train`` its train step (no recall guard
runs in either mode).

``--compute_dtype bfloat16`` profiles the forwards of the bf16 serving
configuration (bf16 conv operands with FP32 results: the bf16 stage
kernel, the trunk's bf16 GEMMs and the casts before them); the weights and
the batch are those of the FP32 run. With ``--train`` it profiles the bf16
train step (JAX's bf16 backward: FP32 products rounded to bf16).
``--compute_dtype float16`` / ``float32`` and ``--matmul_precision``
profile those configurations the same way (``models/dgcnn.py::
DGCNNConfig``'s mode table: "default" rounds the conv operands to TF32
and runs the TF32 stage kernel; f16, "float32" and "highest" run the
unfused chain).
``--remat`` (``--train`` only) recomputes activations in the backward.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

sys.path.insert(0, __file__.rsplit("/", 2)[0])

B, N, K = 8, 7000, 30
# kernel-name fragments -> group, first match wins
GROUPS = (
    ("knn_exact_banded", "knn_exact_banded"),  # the two-phase and the fused kernel
    ("knn_packed_kernel", "knn_packed"),
    ("knn_banded_kernel", "knn_banded"),
    ("knn_banded_tile_kernel", "knn_banded"),
    ("knn_capped_kernel", "knn_capped"),
    ("knn_exact_kernel", "knn_exact"),
    ("knn_approx_", "knn_approx"),  # the two-phase and the fused kernel
    ("gather_rows", "gather_rows"),
    ("scatter_rows", "scatter_add_rows"),
    ("scatter_tail", "scatter_stage_tail_rows"),
    ("multi_tensor", "optimizer (foreach Adam)"),
    ("reduce", "reductions (BN statistics, loss)"),
    ("edgeconv_stage_bf16_kernel", "edgeconv_fused_stage_bf16"),
    ("edgeconv_stage_tf32_kernel", "edgeconv_fused_stage_tf32"),
    ("edgeconv_stage_kernel", "edgeconv_fused_stage"),
    ("edgeconv_extrema_kernel", "edgeconv_fused_extrema"),
    ("gemm", "trunk GEMMs (cuBLAS)"),
    ("nvjet", "trunk GEMMs (cuBLAS)"),  # cuBLAS's own Hopper GEMMs (bf16)
    ("xmma", "trunk GEMMs (cuBLAS)"),
    ("sort", "sort / scan"),
    ("scan", "sort / scan"),
)
NOT_TAKEN_US = 6.0  # a predicated launch that returned at once runs ~2-4 us
TOP_OPS = 12  # operators listed by the device time of their own kernels


def make_blocks(b: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 30.0, (b, n, 3)).astype(np.float32)
    x = np.stack([xi[np.argsort(xi[:, 0], kind="stable")] for xi in x])
    x[..., 2] = rng.uniform(0.0, 5.0, (b, n))
    feat = rng.uniform(0.0, 5.0, (b, n, 1)).astype(np.float32)
    return np.concatenate([x, feat], axis=-1)


def group(name: str) -> str:
    low = name.lower()
    return next((g for frag, g in GROUPS if frag in low), "elementwise / other")


def profile(fn, reps: int, grad: bool = False) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    with contextlib.nullcontext() if grad else torch.inference_mode():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    spans = []
    by_group: dict = {}
    not_taken: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        if t1 <= t0:
            continue
        spans.append((t0, t1))
        g = group(e.name)
        ms, n = by_group.get(g, (0.0, 0))
        by_group[g] = (ms + (t1 - t0) / 1e3, n + 1)
        if g.startswith("knn") and t1 - t0 < NOT_TAKEN_US:
            not_taken[g] = not_taken.get(g, 0) + 1
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    ops = [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
    ops.sort(key=lambda t: -t[1])
    spans.sort()
    busy, cur0, cur1 = 0.0, *spans[0]
    for t0, t1 in spans[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    wall = spans[-1][1] - spans[0][0]
    return {
        "wall_ms_per_forward": wall / 1e3 / reps,
        "busy_ms_per_forward": busy / 1e3 / reps,
        "idle_share": 1.0 - busy / wall,
        "groups": {g: {"ms": ms / reps, "launches": n / reps}
                   for g, (ms, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0])},
        "not_taken_per_forward": {g: n / reps for g, n in not_taken.items()},
        "top_ops": [{"op": op, "ms": ms, "calls": n} for op, ms, n in ops[:TOP_OPS]],
    }


def report(out: dict) -> None:
    for name, res in out.items():
        per = "step" if "step" in name else "forward"
        print(f"\n{name}: wall {res['wall_ms_per_forward']:.3f} ms/{per}, device busy "
              f"{res['busy_ms_per_forward']:.3f} ms, idle share {res['idle_share']:.4f}")
        for g, v in res["groups"].items():
            print(f"  {g:34s} {v['ms']:8.3f} ms  {v['launches']:6.1f} launches")
        print(f"  launches that did no work (< {NOT_TAKEN_US} us): {res['not_taken_per_forward']}")
        print("  operators by the device time of the kernels they launch:")
        for row in res["top_ops"]:
            print(f"    {row['op'][:48]:48s} {row['ms']:8.3f} ms  {row['calls']:6.1f} calls")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "profile": out}))


def profile_train(reps: int, knn_impl: str | None = None, compute_dtype: str | None = None,
                  remat: str = "off", matmul_precision: str | None = None) -> int:
    from dgcnn_tpu_torch.models.dgcnn import DGCNNConfig
    from dgcnn_tpu_torch.train.steps import init_train_state, make_train_step

    cfg = DGCNNConfig(k=K, emb_dims=1024, knn_impl=knn_impl or "auto",
                      compute_dtype=compute_dtype, matmul_precision=matmul_precision)
    state = init_train_state(cfg, seed=1, device="cuda", epochs=30)
    step = make_train_step(cfg, band_guard=knn_impl is None, remat=remat)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(make_blocks(B, N, seed=0)).to("cuda")
    labels = torch.from_numpy(rng.integers(0, 5, (B, N))).to("cuda")
    mask = torch.from_numpy((rng.random((B, N)) < 0.7).astype(np.float32)).to("cuda")
    out = {}
    modes = ((f"train step {knn_impl}", None),) if knn_impl else (
        ("train step guarded (band_mode=1)", 1), ("train step unguarded (band_mode=0)", 0))
    for name, mode in modes:
        out[name] = profile(lambda mode=mode: float(step(state, x, labels, mask, mode)["loss"]),
                            reps, grad=True)
    report(out)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--train", action="store_true", help="profile the train step")
    p.add_argument("--knn_impl", choices=("pallas", "pallas_packed", "approx"), default=None,
                   help="profile the parity, the packed or the approximate mode instead "
                        "of the default and capped-only configurations")
    p.add_argument("--compute_dtype", choices=("bfloat16", "float16", "float32"),
                   default=None,
                   help="profile that configuration's forwards (with --train: its "
                        "train step)")
    p.add_argument("--matmul_precision", choices=("default", "high", "highest"),
                   default=None, help="likewise, the conv products' precision")
    p.add_argument("--remat", choices=("off", "selective", "full"), default="off",
                   help="with --train: recompute activations in the backward")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile needs one GPU")
    if args.train:
        return profile_train(args.reps, args.knn_impl, args.compute_dtype, args.remat,
                             args.matmul_precision)
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn

    cd = dict(compute_dtype=args.compute_dtype, matmul_precision=args.matmul_precision)
    default = DGCNNConfig(k=K, emb_dims=1024, **cd)
    capped = DGCNNConfig(k=K, emb_dims=1024, knn_impl="pallas_capped", knn_band=0,
                         knn_band_feature=0, **cd)
    weights = init_dgcnn(DGCNNConfig(k=K, emb_dims=1024),
                         torch.Generator().manual_seed(1)).state_dict()
    configs = ((args.knn_impl, DGCNNConfig(k=K, emb_dims=1024, knn_impl=args.knn_impl,
                                           **cd)),) \
        if args.knn_impl else (("default", default), ("capped", capped))
    models = {}
    for name, cfg in configs:
        models[name] = DGCNN(cfg)
        models[name].load_state_dict(weights)
        models[name].to("cuda")
    x = torch.from_numpy(make_blocks(B, N, seed=0)).to("cuda")
    if args.knn_impl:
        runs = {args.knn_impl: lambda: models[args.knn_impl](x)}
    else:
        runs = {"default guarded (band_mode=1)": lambda: models["default"](x, band_mode=1),
                "default unguarded (band_mode=0)": lambda: models["default"](x, band_mode=0),
                "capped-only": lambda: models["capped"](x)}
    report({name: profile(fn, args.reps) for name, fn in runs.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
