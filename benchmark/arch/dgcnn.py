"""DGCNN segmentation's pieces for the shared ``tiles`` and ``train`` loops
(``harness/core.py`` gives the contract).

The model is the port's ``DGCNN`` with ``DGCNNConfig`` from the
configuration's ``model`` block and the run's ``overrides``, its weights
from the seed (``harness/weights.py``), a tap on its kNN call
(``harness/tap.py``). Serving follows ``predict()``: a fresh
``make_guarded_predict_step`` a tile (the step and its
``BandGuardScheduler``), then the retroactive re-run of
``suspect_dispatches()`` at ``band_mode=2``. Training takes the guarded
``make_train_step`` with the scheduler's ``next_mode()``, re-armed each
pass. The judges follow the program's graphs with the frozen reference
(``reference/compare.py``).
"""

from __future__ import annotations

DROPOUT_WIDTH = 256  # conv8's output, where the model drops


class Pieces:
    def __init__(self, cfg_file: dict, overrides: dict, seed: int, device):
        from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig
        from harness.tap import KnnTap
        from harness.weights import make_weights

        self.cfg_file, self.device = cfg_file, device
        self.cfg = DGCNNConfig(**{**cfg_file["model"], **overrides})
        self.num_classes = self.cfg.num_classes
        self.weights = make_weights(cfg_file["model"], seed, device)
        self.module = DGCNN(self.cfg).to(device)
        self.module.load_state_dict(self.weights)
        self.tap = KnnTap(self.module)

    # serving
    def serve(self, conf: float, unclassified: int) -> None:
        from dgcnn_tpu_torch.train.steps import make_predict_step

        self._serve_kw = {"min_class_confidence": conf, "unclassified": unclassified}
        self._full_step = make_predict_step(**self._serve_kw, band_flag=True)

    def tile(self) -> _Tile:
        return _Tile(self)

    def warm_rerun(self, points) -> None:
        self._full_step(self.module, points, band_mode=2)

    # training
    def train_step(self):
        from dgcnn_tpu_torch.train.steps import BandGuardScheduler, make_train_step

        self._sched = BandGuardScheduler(self.cfg, self.device)
        return make_train_step(self.cfg, smoothing=self.cfg_file["train"]["smoothing"],
                               band_guard=self._sched.active)

    def next_mode(self) -> tuple[tuple, bool]:
        if not self._sched.active:
            return (), False
        mode, guarded = self._sched.next_mode()
        return (mode,), guarded

    def observe(self, flag: bool) -> None:
        self._sched.observe(flag)

    def rearm(self) -> None:
        self._sched.rearm()


class _Tile:
    """One tile: the guarded step and the scheduler it feeds."""

    def __init__(self, pieces: Pieces):
        from dgcnn_tpu_torch.train.steps import make_guarded_predict_step

        self._pieces = pieces
        self._step, self._sched = make_guarded_predict_step(
            pieces.cfg, pieces.device, **pieces._serve_kw)

    def step(self, points):
        return self._step(self._pieces.module, points)

    def suspects(self) -> list:
        return self._sched.suspect_dispatches()

    def rerun(self, points):
        return self._pieces._full_step(self._pieces.module, points, band_mode=2)[:3]

    @property
    def tripped(self) -> int:
        return self._sched.tripped


def judge_tiles(samples, weights, cfg_file, device) -> dict:
    from compare import judge_tiles

    return judge_tiles(samples, weights, cfg_file["model"]["k"],
                       cfg_file["min_class_confidence"], device)


def judge_train(weights, batches, idxs, dropout_seed, program, cfg_file, device) -> dict:
    from compare import judge_train, keep_masks

    b, n = batches[0][0].shape[:2]
    keep = keep_masks(dropout_seed, (b, n, DROPOUT_WIDTH), cfg_file["model"]["dropout"],
                      len(batches), device)
    return judge_train(weights, batches, idxs, keep, program, cfg_file, device)
