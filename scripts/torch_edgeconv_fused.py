"""Time the port's fused EdgeConv stage and extrema kernels
(``csrc/edgeconv_fused.cu``) and hold their outputs against another tree's.

    python scripts/torch_edgeconv_fused.py [--root DIR] [--label NAME] [--out DIR] [--variants]

``--root`` is a checkout whose ``dgcnn_tpu_torch`` is measured (default:
this one), so that two trees are compared in one run on one card: unpack
the other tree with ``git archive`` into a directory that ``.gitignore``
lists and run the script on both in turns (A, B, B, A), with one ``--out``.

The inputs are ``chip_smoke.stage_cases`` (this checkout's), made from one
seed: B=8, N=7000, k=30 with ``knn_capped`` indices on C=64 normals
(spread over the whole cloud), with forward-like ones (the banded kNN of
``make_blocks`` points at band 2048 and of the C=64 normals at band 4096,
local in x-sorted order) and with the default forward's own stage-3
indices, then B=1, N=1001, k = 20, 30, 40. Per input:

* the stage and the extrema kernels' outputs are held within 1e-5 of their
  plain versions and written to ``--out``; where a run on another tree
  wrote them first, both trees' must be ``torch.equal``;
* at B=8 (not the ragged cases): ``ms`` and ``extrema_ms``, each wrapper's
  call device-only (``chip_smoke.cuda_ms_many``: 50 back-to-back calls per
  pair of CUDA events queued behind a device sleep, median of 10 runs);
  ``cublas_ms``, cuBLAS FP32 (TF32 off) for the bare (B*N*k, 64) x (64, 64)
  product of the stage: a ceiling, not a yardstick (it neither gathers nor
  reduces); ``bound_ms``, the stage's FP32 bound (2 * B*N*k*64*64
  operations at 67 TFLOP/s) and ``share``, the bound over ``ms``;
* at B=8, the indices' sharing: per tile of Q consecutive queries (Q = 16,
  32, 64, 128) the share of distinct rows among its Q*k (clamped) indices
  and the tile's row span, mean and median over tiles, and the largest
  distinct count; and ``extrema_l2_bound_ms``, the extrema's B*N*k
  gathered rows of 256 bytes at the card's L2 read rate for such a gather,
  measured in the same run by ``chip_smoke.l2_gather_rate`` (a diagnostic
  build that reads every (query, neighbour) row from L2, on row-local
  indices).

Then the default forward (``chip_smoke.py``'s phase 6 model: emb 1024,
seeded weights, the ``make_blocks`` batch, a guarded dispatch): its
probabilities go to ``--out`` and must be ``torch.equal`` to the other
tree's.

``--variants`` (a tree whose wrapper has ``launch_geometry``) also times
the stage kernel at the launch geometries of ``GEOMETRIES`` (warps per
block, staging buffers per warp, blocks: 0 for the persistent grid), and
(a tree whose wrapper has ``launch_extrema``) the extrema kernel at the
grids of ``EXTREMA_GRIDS``, each held ``torch.equal`` to the shipped
launch's output. Prints one JSON line: the
card's ``nvidia-smi`` name and power limit, the root, the cases.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# --variants: (warps, nbuf, grid) beside the shipped geometry; grid 0 is the
# persistent grid, 7000 a block of 8 warps per 8 queries at B=8, N=7000
GEOMETRIES = [(8, 1, 0), (8, 2, 0), (12, 1, 0), (12, 2, 0), (4, 2, 0), (6, 2, 0),
              (8, 2, 7000)]
# --variants: blocks of the extrema kernel (0: one an SM), each a
# contiguous range of queries
EXTREMA_GRIDS = [0, 264, 66]
SHARING_Q = (16, 32, 64, 128)


def sharing(idx, n: int, q: int) -> dict:
    """Distinct rows among each tile of ``q`` consecutive queries' clamped
    indices (tiles within one cloud), and the tile's row span."""
    import torch

    b, _, k = idx.shape
    t = idx.clamp(0, n - 1)[:, : n // q * q].reshape(b, n // q, q * k)
    srt = t.sort(-1).values
    distinct = 1 + (srt[..., 1:] != srt[..., :-1]).sum(-1)
    span = (srt[..., -1] - srt[..., 0] + 1).float()
    share = distinct.float() / (q * k)
    return {"distinct_share_mean": share.mean().item(),
            "distinct_share_median": share.median().item(),
            "distinct_max": int(distinct.max()),
            "span_median": span.median().item(), "span_mean": span.mean().item()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose port is measured")
    ap.add_argument("--label", default="", help="a name for the root in the output")
    ap.add_argument("--out", default="", help="directory of the outputs to hold trees against")
    ap.add_argument("--variants", action="store_true", help="also time other launch geometries")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)  # the measured package first
    spec = importlib.util.spec_from_file_location("chip_smoke_fused", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the fused stage kernels run on one GPU")
    import dgcnn_tpu_torch
    from dgcnn_tpu_torch.kernels import edgeconv_fused as mod

    if not Path(dgcnn_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {dgcnn_tpu_torch.__file__}, not the port under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    out = Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)

    def hold(name: str, tensors: dict):
        """Save ``tensors`` under ``name`` or hold them equal to the saved
        ones; returns the root that saved them first, or None."""
        if out is None:
            return None
        path = out / (name.replace(" ", "_").replace("=", "").replace(",", "")
                      .replace("(", "").replace(")", "") + ".pt")
        if not path.exists():
            torch.save({**{k: v.cpu() for k, v in tensors.items()}, "root": root}, path)
            return None
        other = torch.load(path)
        for key, v in tensors.items():
            if not torch.equal(v.cpu(), other[key]):
                raise AssertionError(f"{name}: {key} differs from {other['root']}'s")
        return other["root"]

    cases = {}
    # the L2 ceiling: a diagnostic build of this tree's extrema kernel
    new_extrema = hasattr(mod, "launch_extrema")
    diag = cs.start_l2_diag(HERE / "build" / "torch_edgeconv_fused") if new_extrema else None
    inputs = cs.stage_cases(dev)
    l2 = cs.l2_gather_rate(diag, inputs["capped C=64"]["table"], cs.K) if new_extrema else None
    for name, case in inputs.items():
        st, ex = cs.stage_args(case), cs.extrema_args(case)
        got, got_ex = mod.edgeconv_fused_stage(*st), mod.edgeconv_fused_extrema(*ex)
        torch.cuda.synchronize()
        errs = {"stage_err": (got - mod.edgeconv_fused_stage_plain(*st)).abs().max().item(),
                "extrema_err": (got_ex - mod.edgeconv_fused_extrema_plain(*ex)).abs().max().item()}
        for key, err in errs.items():
            if not err <= 1e-5:
                raise AssertionError(f"{name}: {key} {err} > 1e-5 against the plain version")
        row = {**errs, "equal_to": hold(name, {"stage": got, "extrema": got_ex})}
        if not name.startswith("ragged"):
            b, n, k = case["idx"].shape
            b_ms, _ = cs.bound(0.0, 2.0 * b * n * k * 64 * 64)
            e = torch.randn(b * n * k, 64, device=dev)
            row.update({
                "ms": cs.cuda_ms_many(lambda: mod.edgeconv_fused_stage(*st)),
                "extrema_ms": cs.cuda_ms_many(lambda: mod.edgeconv_fused_extrema(*ex)),
                "cublas_ms": cs.cuda_ms_many(lambda: torch.mm(e, case["w2"]), 10, 5),
                "bound_ms": b_ms})
            row["share"] = b_ms / row["ms"]
            row["extrema_l2_bound_ms"] = l2 and l2["ms"]
            row["sharing"] = {q: sharing(case["idx"], n, q) for q in SHARING_Q}
            del e
            if args.variants and new_extrema:
                vec = [case[key] for key in ("gamma", "s5", "t5")]
                t, i, bv = (case[key] for key in ("table", "idx", "bvec"))
                var = {}
                for grid in EXTREMA_GRIDS:
                    def run_ex(grid=grid):
                        return mod.launch_extrema(t, i, bv, vec, grid)
                    if not torch.equal(run_ex(), got_ex):
                        raise AssertionError(f"{name}: extrema grid {grid} changes the outputs")
                    var[f"grid={grid}"] = cs.cuda_ms_many(run_ex)
                row["extrema_variants"] = var
            if args.variants and hasattr(mod, "launch_geometry"):
                vec = [case[key] for key in ("sa", "ta", "sb", "tb")]
                t, i, bv, w2 = (case[key] for key in ("table", "idx", "bvec", "w2"))
                var = {}
                for warps, nbuf, grid in GEOMETRIES:
                    def run(g=(warps, nbuf), grid=grid):
                        return mod.launch_stage(t, i, bv, w2, vec, g, grid)
                    if not torch.equal(run(), got):
                        raise AssertionError(f"{name}: geometry {(warps, nbuf, grid)} "
                                             "changes the outputs")
                    var[f"warps={warps} nbuf={nbuf} grid={grid}"] = cs.cuda_ms_many(run)
                row["variants"] = var
        cases[name] = row
        print(f"{args.label or root} {name}: " + ", ".join(
            f"{key} {v:.4f}" if isinstance(v, float) else f"{key} {v}"
            for key, v in row.items() if key not in ("sharing", "extrema_variants")),
              file=sys.stderr)

    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig, init_dgcnn

    cfg = DGCNNConfig(k=cs.K, emb_dims=1024)
    model = DGCNN(cfg)
    model.load_state_dict(init_dgcnn(cfg, torch.Generator().manual_seed(1)).state_dict())
    x = torch.from_numpy(cs.make_blocks(cs.B, cs.N, seed=0)).to(dev)
    with torch.inference_mode():
        prob = torch.softmax(model.to(dev)(x, band_mode=1), -1)
    cases["forward"] = {"equal_to": hold("forward prob", {"prob": prob})}
    print(json.dumps({"label": args.label, "root": root, "device": smi, "l2_gather": l2,
                      "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
