"""Batched evaluation over a processed dataset, with per-room dump files,
and the model restore shared with prediction.

Counterpart of ``dgcnn_tpu/eval/test.py``: :func:`restore` (``_restore``),
:func:`test`, :func:`test_all` and :func:`test_args` (``main.py --mode
classifier --eval 1``; here ``python -m dgcnn_tpu_torch.train --eval 1``).
:func:`test` loads the validation partition, runs batched inference on
``device`` with confidence thresholding (max softmax probability below
``min_class_confidence`` -> LAS class 31, UNCLASSIFIED), writes per-room
``Area_{a}_room_{r}_pred_gt.txt`` (x y z pred, or with ``dump_logits``
x y z feat(3) pred gt logits...) and ``*_true_labels.txt`` dumps, and
reports accuracy, balanced accuracy, the confusion matrix and per-class
IoU. The (C+1)-wide confusion matrix counts UNCLASSIFIED predictions as
wrong. The predict step is the guarded one; when the amortized recall
guard trips, the batches it calls into question are re-scored with the
capped kNN (``band_mode=2``) after the loop, the sampler's RNG restored so
that the batches re-enumerate bit for bit, and their contributions
replaced. ``band_repaired`` counts the batches re-scored.
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np
import torch

from dgcnn_tpu_torch.data.dataset import FugroDataset
from dgcnn_tpu_torch.models.dgcnn import (
    DGCNN,
    DGCNNConfig,
    count_parameters,
    resolve_knn_impl,
)
from dgcnn_tpu_torch.ops.metrics import (
    accuracy_from_confusion,
    balanced_accuracy_from_confusion,
    calculate_sem_iou,
    confusion_matrix,
    iou_from_confusion,
)
from dgcnn_tpu_torch.train.steps import make_guarded_predict_step, make_predict_step
from dgcnn_tpu_torch.utils.logging import IOStream

UNCLASSIFIED = 31

_RESTORE_CACHE: dict = {}


def _jax_leaf_name(key: str) -> str:
    """``conv1.w`` -> ``params/conv1/w``; ``bn1.mean`` -> ``bn_state/bn1/mean``."""
    name, leaf = key.split(".")
    field = "bn_state" if leaf in ("mean", "var") else "params"
    return f"{field}/{name}/{leaf}"


def restore(cfg: DGCNNConfig, model_root: str, model_label: str, io,
            device: torch.device | str) -> DGCNN:
    """The model in eval mode on ``device``, from ``<model_label>.npz``
    (the JAX checkpoint layout) or else ``<model_label>.t7`` (reference).

    Cached on (cfg, file identity, device) as the JAX restore is: the
    serve loop restores the same model for every tile through a fresh
    ``predict()``. A changed file (mtime or size) misses the cache; the
    module is never mutated downstream, so sharing it is safe."""
    t7 = os.path.join(model_root, f"{model_label}.t7")
    npz = os.path.join(model_root, f"{model_label}.npz")
    path = npz if os.path.exists(npz) else t7
    try:
        st = os.stat(path)
    except OSError:
        raise FileNotFoundError(f"no checkpoint {npz} or {t7}") from None
    key = (cfg, os.path.abspath(path), st.st_mtime_ns, st.st_size, str(device))
    hit = _RESTORE_CACHE.get(key)
    if hit is not None:
        io.cprint(f"{os.path.basename(path)} restored.")
        return hit
    model = DGCNN(cfg)
    if path == npz:
        from dgcnn_tpu_torch.train.checkpoint import load_named

        want = {_jax_leaf_name(k): tuple(v.shape)
                for k, v in model.state_dict().items()}
        leaves = load_named(npz, want)
        sd = {k: torch.from_numpy(leaves[_jax_leaf_name(k)].astype("float32"))
              for k in model.state_dict()}
    else:
        from dgcnn_tpu_torch.compat.torch_ckpt import load_torch_checkpoint

        sd = load_torch_checkpoint(t7)["state_dict"]
    model.load_state_dict(sd)
    io.cprint(f"{os.path.basename(path)} restored.")
    model = model.to(device)
    while len(_RESTORE_CACHE) >= 4:  # bound device-memory retention
        _RESTORE_CACHE.pop(next(iter(_RESTORE_CACHE)))
    _RESTORE_CACHE[key] = model
    return model


def test(
    k: int,
    io: IOStream,
    data_dir: str = "",
    num_points: int = 7000,
    num_classes: int = 5,
    num_features: int = 4,
    test_batch_size: int = 8,
    dropout: float = 0.5,
    emb_dims: int = 1024,
    use_all_points: bool = False,
    min_class_confidence: float = 0.8,
    model_label: str = "dgcnn_model",
    model_root: str = "checkpoints/dgcnn",
    pred_dir: str = "predict",
    test_area: str = "1",
    seed: int = 1,
    knn_impl: str = "auto",
    knn_band: int | None = None,
    knn_band_feature: int | None = None,
    knn_band_recall_guard: int | None = None,
    knn_band_recall_threshold: float | None = None,
    knn_band_guard_every: int | None = None,
    knn_share_stage3: bool = False,
    compute_dtype: str | None = None,
    matmul_precision: str | None = None,
    dump_logits: bool = False,
    validation_prop: float = 0.2,
    device: torch.device | str = "cuda",
) -> dict:
    """Evaluate a trained model on ``device``; returns a metrics dict."""
    optional = {
        "knn_band": knn_band, "knn_band_feature": knn_band_feature,
        "knn_band_recall_guard": knn_band_recall_guard,
        "knn_band_recall_threshold": knn_band_recall_threshold,
        "knn_band_guard_every": knn_band_guard_every,
    }
    cfg = DGCNNConfig(
        num_classes=num_classes, num_features=num_features, k=k, dropout=dropout,
        emb_dims=emb_dims, knn_impl=knn_impl, compute_dtype=compute_dtype,
        matmul_precision=matmul_precision, knn_share_stage3=bool(knn_share_stage3),
        **{name: v for name, v in optional.items() if v is not None},
    )
    device = torch.device(device)
    resolve_knn_impl(cfg, device)  # unported kNN configs fail before loading
    dataset = FugroDataset(
        "test", data_dir, num_point=num_points, use_all_points=use_all_points,
        seed=seed, validation_prop=validation_prop, classes=range(num_classes),
    )
    os.makedirs(pred_dir, exist_ok=True)
    io.cprint("Start overall evaluation...")
    model = restore(cfg, model_root, model_label, io, device)
    _, table = count_parameters(model)
    io.cprint(table)
    predict_step, band_sched = make_guarded_predict_step(
        cfg, device, min_class_confidence=min_class_confidence, unclassified=UNCLASSIFIED)

    io.cprint("Start testing ...")
    cm = np.zeros((num_classes + 1, num_classes + 1))
    room_preds: dict[int, list] = defaultdict(list)
    room_truth: dict[int, list] = defaultdict(list)
    dumps: dict[int, list] = defaultdict(list)

    def _fold(batch, pred, logits):
        """One batch's contributions ``(cm, [(room, pred_rows, truth_rows,
        dump_row), ...])``, a pure function of (batch, pred, logits), so a
        repair re-run can replace them exactly."""
        bcm = confusion_matrix(torch.from_numpy(np.minimum(pred, num_classes)),
                               torch.from_numpy(batch.labels), num_classes + 1,
                               weights=torch.from_numpy(batch.mask)).numpy()
        entries = []
        for i, room in enumerate(np.asarray(batch.room_idx)):
            valid = batch.mask[i] > 0
            row = [batch.points[i][valid][:, :3], pred[i][valid, None]]
            if dump_logits:
                # columns 3:6: the non-xyz input features, zero-padded to
                # width 3; columns 8: the raw logits
                feats = batch.points[i][valid][:, 3:6]
                if feats.shape[1] < 3:
                    feats = np.hstack([feats, np.zeros((valid.sum(), 3 - feats.shape[1]))])
                row = [batch.points[i][valid][:, :3], feats, pred[i][valid, None],
                       batch.labels[i][valid, None].astype(float), logits[i][valid]]
            entries.append((int(room), pred[i][valid], batch.labels[i][valid],
                            np.hstack(row)))
        return bcm, entries

    def batch_iter():
        return dataset.batches(test_batch_size, shuffle=False, drop_last=False,
                               with_mask=False)

    def points_of(batch) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(batch.points)).to(device)

    batch_cms: list = []    # per-dispatch cm contribution (repair undo)
    batch_slots: list = []  # per-dispatch [(room, list position), ...]
    # the batch order is fixed, but every sample draws its points from the
    # dataset's stateful generator: restoring it re-enumerates the batches
    # bit for bit for the repair
    rng_state = dataset.rng.bit_generator.state
    for batch in batch_iter():
        pred, _, logits = predict_step(model, points_of(batch))
        bcm, entries = _fold(batch, pred.cpu().numpy(), logits.cpu().numpy())
        cm += bcm
        batch_cms.append(bcm)
        slots = []
        for room, p, t, dump_row in entries:
            slots.append((room, len(room_preds[room])))
            room_preds[room].append(p)
            room_truth[room].append(t)
            dumps[room].append(dump_row)
        batch_slots.append(slots)

    # retroactive repair of the amortized guard's exposure window (as in
    # eval/predict.py): the suspect batches re-run with the capped kNN and
    # replace their contributions; a healthy run pays one poll
    redo = set(band_sched.suspect_dispatches())
    repaired = 0
    if redo:
        dataset.rng.bit_generator.state = rng_state
        io.cprint(f"feature-band recall guard tripped: re-scoring {len(redo)} unguarded "
                  "batch(es) with the full kNN kernel (retroactive repair of the "
                  "amortization window)")
        full_step = make_predict_step(min_class_confidence=min_class_confidence,
                                      unclassified=UNCLASSIFIED, band_flag=True)
        for bi, batch in enumerate(batch_iter()):
            if bi not in redo:
                continue
            pred, _, logits, _ = full_step(model, points_of(batch), band_mode=2)
            bcm, entries = _fold(batch, pred.cpu().numpy(), logits.cpu().numpy())
            cm += bcm - batch_cms[bi]
            for (room, pos), (_, p, _t, dump_row) in zip(batch_slots[bi], entries):
                room_preds[room][pos] = p
                dumps[room][pos] = dump_row
            repaired += 1

    for room, rows in dumps.items():
        np.savetxt(os.path.join(pred_dir, f"Area_{test_area}_room_{room}_pred_gt.txt"),
                   np.vstack(rows), fmt="%f")
        np.savetxt(os.path.join(pred_dir, f"Area_{test_area}_room_{room}_true_labels.txt"),
                   np.concatenate(room_truth[room])[:, None], fmt="%d")

    acc = float(accuracy_from_confusion(cm))
    bacc = float(balanced_accuracy_from_confusion(cm))
    io.cprint("Test :: test area: %s, test acc: %.6f, test avg acc: %.6f"
              % (test_area, acc, bacc))
    io.cprint("Confusion matrix:")
    io.cprint(str(cm.astype(np.int64)))
    ious = calculate_sem_iou(
        [np.concatenate(room_preds[r]) for r in sorted(room_preds)],
        [np.concatenate(room_truth[r]) for r in sorted(room_truth)],
        num_classes,
    )
    io.cprint(f"per-class IoU: {ious}")
    return {
        "accuracy": acc,
        "balanced_accuracy": bacc,
        "confusion": cm,
        "iou": ious,
        "mean_iou": float(np.nanmean(ious)),
        "band_repaired": repaired,
    }


def test_all(k: int, io: IOStream, data_dirs: "dict[str, str] | list[str]",
             **kwargs) -> dict:
    """:func:`test` over several area datasets, then accuracy, balanced
    accuracy and mean IoU over the union of their points, from the summed
    confusion matrix. ``data_dirs``: {area: npy dir}, or a list (each
    dir's basename names its area, the path where basenames collide)."""
    if not isinstance(data_dirs, dict):
        named = {}
        for i, d in enumerate(data_dirs):
            name = os.path.basename(os.path.normpath(d)) or str(i)
            if name in named:  # e.g. .../Area_1/npy and .../Area_2/npy
                name = os.path.normpath(d).replace(os.sep, "_").lstrip("_")
            named[name] = d
        data_dirs = named
        if len(data_dirs) != len(list(dict.fromkeys(data_dirs.values()))):
            raise ValueError(f"duplicate data dirs in {list(data_dirs)}")
    kwargs.pop("test_area", None)
    cm_sum = None
    per_area = {}
    for area, d in data_dirs.items():
        m = test(k, io, data_dir=d, test_area=area, **kwargs)
        per_area[area] = m
        cm_sum = m["confusion"] if cm_sum is None else cm_sum + m["confusion"]
    acc = float(accuracy_from_confusion(cm_sum))
    bacc = float(balanced_accuracy_from_confusion(cm_sum))
    # the trailing row and column are the UNCLASSIFIED bucket, not a class
    ious = iou_from_confusion(cm_sum).numpy()[: cm_sum.shape[0] - 1]
    io.cprint("Overall Test :: test acc: %.6f, test avg acc: %.6f, test iou: %.6f"
              % (acc, bacc, float(np.nanmean(ious))))
    return {
        "accuracy": acc,
        "balanced_accuracy": bacc,
        "confusion": cm_sum,
        "iou": ious,
        "mean_iou": float(np.nanmean(ious)),
        "areas": per_area,
    }


def test_args(args, io: IOStream) -> dict:
    """CLI adapter (``--eval 1``): ``--validation_area all`` aggregates
    over the comma-separated ``--data_dir`` entries."""
    kwargs = dict(
        num_points=args.num_points, num_classes=args.num_classes,
        num_features=args.num_features, test_batch_size=args.test_batch_size,
        dropout=args.dropout, emb_dims=args.emb_dims, use_all_points=args.use_all_points,
        min_class_confidence=args.min_class_confidence, model_label=args.model_label,
        model_root=args.model_root, pred_dir=args.test_visu_dir, seed=args.seed,
        knn_impl=args.knn_impl, knn_band=args.knn_band,
        knn_band_feature=args.knn_band_feature,
        knn_band_recall_guard=args.knn_band_recall_guard,
        knn_band_recall_threshold=args.knn_band_recall_threshold,
        knn_band_guard_every=args.knn_band_guard_every,
        knn_share_stage3=args.knn_share_stage3, compute_dtype=args.compute_dtype,
        matmul_precision=args.matmul_precision, validation_prop=args.validation_prop,
        device=args.device,
    )
    if args.validation_area == "all":
        dirs = [d for d in str(args.data_dir).split(",") if d]
        return test_all(args.k, io, dirs, **kwargs)
    return test(args.k, io, data_dir=args.data_dir, test_area=args.validation_area, **kwargs)
