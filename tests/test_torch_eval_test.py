"""The port's evaluation entry point (dgcnn_tpu_torch.eval.test) against the
JAX package's on the CPU: ``test()`` on the same synthetic ``Area_*``
rooms and the same ``.npz`` checkpoint (confusion matrix, metrics, the
per-room dump files), ``test_all`` over two areas, UNCLASSIFIED counted
wrong, ``calculate_sem_iou``, the retroactive repair over two batches, and
``--eval 1`` through the port's train CLI."""

import glob
import os

import numpy as np
import pytest

from dgcnn_tpu.eval.test import test as jax_test
from dgcnn_tpu.eval.test import test_all as jax_test_all
from dgcnn_tpu.models.dgcnn import DGCNNConfig as JaxConfig
from dgcnn_tpu.ops.metrics import calculate_sem_iou as jax_sem_iou
from dgcnn_tpu.train.checkpoint import save_checkpoint
from dgcnn_tpu.utils.logging import IOStream
from dgcnn_tpu_torch.eval.test import UNCLASSIFIED
from dgcnn_tpu_torch.eval.test import test as port_test
from dgcnn_tpu_torch.eval.test import test_all as port_test_all
from dgcnn_tpu_torch.ops.metrics import calculate_sem_iou
from dgcnn_tpu_torch.train import steps as port_steps
from torch_port_helpers import jax_weights, write_rooms

K, EMB, NUM_POINTS = 8, 32, 256
KW = dict(num_points=NUM_POINTS, num_classes=5, num_features=4, test_batch_size=2,
          emb_dims=EMB, min_class_confidence=0.4, model_label="dgcnn_model",
          validation_prop=0.5, seed=3)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_eval")
    p, s = jax_weights(JaxConfig(k=K, emb_dims=EMB), seed=6)
    # a sharper classifier head than the init's, so that both confident
    # classes and the UNCLASSIFIED threshold occur
    p["conv9"]["w"] = p["conv9"]["w"] * 8.0
    save_checkpoint(str(d / "ckpt" / "dgcnn_model.npz"), {"params": p, "bn_state": s})
    for area, seed in (("A", 7), ("B", 8)):
        (d / area).mkdir()
        write_rooms(str(d / area), n_rooms=6, n_points=600, seed=seed)
    return d


def _kw(work, **over):
    return dict(KW, model_root=str(work / "ckpt"), **over)


def _dumps(pred_dir):
    return sorted(os.path.basename(f) for f in glob.glob(os.path.join(pred_dir, "Area_*")))


def _same_dumps(ours, theirs, dump_logits):
    names = _dumps(ours)
    assert names and names == _dumps(theirs)
    for name in names:
        a, b = np.loadtxt(os.path.join(ours, name)), np.loadtxt(os.path.join(theirs, name))
        assert a.shape == b.shape
        if not dump_logits or name.endswith("_true_labels.txt"):
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        # x y z feat(3) pred gt: equal; the logits: FP32 sum order
        np.testing.assert_array_equal(a[:, :8], b[:, :8], err_msg=name)
        np.testing.assert_allclose(a[:, 8:], b[:, 8:], atol=1e-4, rtol=0, err_msg=name)


def _same_metrics(ours, theirs):
    """Equal confusion matrices; the metrics derived from them agree to
    the JAX package's float32 (the port derives them in float64)."""
    np.testing.assert_array_equal(ours["confusion"], theirs["confusion"])
    for key in ("accuracy", "balanced_accuracy", "mean_iou"):
        assert ours[key] == pytest.approx(theirs[key], rel=1e-6, abs=1e-7), key
    np.testing.assert_allclose(np.asarray(ours["iou"], float),
                               np.asarray(theirs["iou"], float), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dump_logits", [False, True])
def test_port_test_equals_jax_test(work, tmp_path, dump_logits):
    io = IOStream(str(tmp_path / "test.log"))
    kw = _kw(work, data_dir=str(work / "A"), dump_logits=dump_logits)
    theirs = jax_test(K, io, pred_dir=str(tmp_path / "jax"), **kw)
    ours = port_test(K, io, pred_dir=str(tmp_path / "port"), device="cpu", **kw)
    _same_metrics(ours, theirs)
    assert ours["band_repaired"] == theirs["band_repaired"] == 0
    _same_dumps(str(tmp_path / "port"), str(tmp_path / "jax"), dump_logits)
    # 3 rooms of 256 points, counted once each
    assert ours["confusion"].sum() == 3 * NUM_POINTS
    assert "Test :: test area: 1" in open(tmp_path / "test.log").read()


def test_unclassified_counts_wrong(work, tmp_path):
    """min_class_confidence 0.99: most points are UNCLASSIFIED, which the
    (C+1)-wide matrix keeps in its last column, as JAX's does."""
    io = IOStream(str(tmp_path / "unc.log"))
    kw = _kw(work, data_dir=str(work / "A"), min_class_confidence=0.99)
    theirs = jax_test(K, io, pred_dir=str(tmp_path / "jax"), **kw)
    ours = port_test(K, io, pred_dir=str(tmp_path / "port"), device="cpu", **kw)
    _same_metrics(ours, theirs)
    cm = ours["confusion"]
    assert cm.shape == (6, 6) and cm[:, 5].sum() > 0 and cm[5].sum() == 0
    assert ours["accuracy"] == pytest.approx(np.trace(cm) / cm.sum())
    preds = np.concatenate([np.loadtxt(f)[:, 3] for f in
                            glob.glob(str(tmp_path / "port" / "*_pred_gt.txt"))])
    assert (preds == UNCLASSIFIED).sum() == cm[:, 5].sum()


def test_test_all_over_two_areas(work, tmp_path):
    io = IOStream(str(tmp_path / "all.log"))
    kw = _kw(work)
    areas = {"A": str(work / "A"), "B": str(work / "B")}
    theirs = jax_test_all(K, io, areas, pred_dir=str(tmp_path / "jax"), **kw)
    ours = port_test_all(K, io, areas, pred_dir=str(tmp_path / "port"), device="cpu", **kw)
    _same_metrics(ours, theirs)
    assert set(ours["areas"]) == {"A", "B"} and len(ours["iou"]) == 5
    np.testing.assert_array_equal(ours["confusion"], ours["areas"]["A"]["confusion"]
                                  + ours["areas"]["B"]["confusion"])
    _same_dumps(str(tmp_path / "port"), str(tmp_path / "jax"), False)
    assert "Overall Test ::" in open(tmp_path / "all.log").read()


@pytest.mark.parametrize("seed", [0, 1])
def test_calculate_sem_iou_equals_the_original(seed):
    rng = np.random.default_rng(seed)
    preds = [rng.integers(0, 5, n) for n in (50, 80, 13)]
    truth = [rng.integers(0, 4, n) for n in (50, 80, 13)]  # class 4: never true
    ours = calculate_sem_iou(preds, truth, 6)  # class 5: in neither -> NaN
    np.testing.assert_array_equal(ours, jax_sem_iou(preds, truth, 6))
    assert np.isnan(ours[5])


GUARDED = dict(knn_impl="pallas_capped", knn_band=0, knn_band_feature=256,
               knn_band_recall_guard=16, knn_band_guard_every=4, dump_logits=True,
               min_class_confidence=0.0)


@pytest.mark.parametrize("suspects, repaired", [([0, 1], 2), ([0, 1, 99], 2)])
def test_forced_trip_repair_replaces_two_batches(work, tmp_path, monkeypatch,
                                                 suspects, repaired):
    """test()'s repair re-scores the suspect batches (banding is inert at
    this size, so the mode-2 re-runs are bit-identical) and replaces their
    contributions exactly: metrics and dump files equal the untouched run.
    ``band_repaired`` counts the batches re-scored: a suspect index past the
    last batch is not one (JAX counts the suspects)."""
    io = IOStream(str(tmp_path / "repair.log"))
    kw = _kw(work, data_dir=str(work / "A"), **GUARDED)
    ref = port_test(K, io, pred_dir=str(tmp_path / "pa"), device="cpu", **kw)
    assert ref["band_repaired"] == 0
    forced = {"arm": True}

    def fake_suspects(self):
        return suspects if forced.pop("arm", None) else []

    monkeypatch.setattr(port_steps.BandGuardScheduler, "suspect_dispatches", fake_suspects)
    fix = port_test(K, io, pred_dir=str(tmp_path / "pb"), device="cpu", **kw)
    assert not forced  # the repair pass consumed the forced list
    assert fix["band_repaired"] == repaired
    _same_metrics(fix, ref)
    for name in _dumps(tmp_path / "pa"):
        np.testing.assert_array_equal(np.loadtxt(tmp_path / "pb" / name),
                                      np.loadtxt(tmp_path / "pa" / name))
    assert "re-scoring" in open(tmp_path / "repair.log").read()


def test_eval_cli_scores_the_checkpoint(work, tmp_path, monkeypatch):
    """``python -m dgcnn_tpu_torch.train --eval 1`` (in-process, on the
    CPU): the metrics of test() with the same settings, the dumps in
    ``--test_visu_dir``, the log under checkpoints/<exp_name>."""
    from dgcnn_tpu_torch.train.__main__ import main

    monkeypatch.chdir(tmp_path)
    args = ["--eval", "1", "--data_dir", str(work / "A"), "--k", str(K),
            "--num_points", str(NUM_POINTS), "--num_features", "4", "--emb_dims", str(EMB),
            "--test_batch_size", "2", "--validation_prop", "0.5", "--seed", "3",
            "--min_class_confidence", "0.4", "--model_root", str(work / "ckpt"),
            "--test_visu_dir", str(tmp_path / "dumps"), "--device", "cpu"]
    assert main(args) == 0
    log = open(tmp_path / "checkpoints" / "dgcnn_tpu" / "run.log").read()
    assert "Test :: test area: 1" in log and "per-class IoU" in log
    assert _dumps(tmp_path / "dumps")
    want = port_test(K, IOStream(str(tmp_path / "direct.log")), data_dir=str(work / "A"),
                     pred_dir=str(tmp_path / "direct"), device="cpu", **_kw(work))
    _same_dumps(str(tmp_path / "dumps"), str(tmp_path / "direct"), False)
    assert f"test acc: {want['accuracy']:.6f}" in log


def test_test_refuses_unported_configs(work, tmp_path):
    io = IOStream(str(tmp_path / "fence.log"))
    with pytest.raises(NotImplementedError, match="item 12"):
        port_test(K, io, data_dir=str(work / "A"), device="cpu",
                  **_kw(work, compute_dtype="bfloat16"))
