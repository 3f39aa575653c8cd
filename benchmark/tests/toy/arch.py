"""A throwaway architecture for the harness's tests, copied in as
``arch/toy.py``: a per-point two-layer model in plain ``torch`` (F -> hidden
-> classes), its weights from the seed, no guard, and its judges against a
float64 reference in this file.

Numbers of a ``tiles`` cell: ``logit_gap`` (the largest |l - l_ref| of a
sampled block over its largest |l_ref|, by the worst block) and
``label_rule`` (sampled points whose label is not the serving rule applied
to the served probabilities); no sample fails both. Of a ``train`` cell:
``loss_gap.1`` (the first step's relative loss gap) and ``grad_gap`` (the
first gradient as Adam took it, by the worst leaf).
"""

from __future__ import annotations

import math

import torch

from harness.core import generator


def _plan(model: dict) -> dict[str, tuple[int, int]]:
    return {"conv1": (model["num_features"], model["hidden"]),
            "conv2": (model["hidden"], model["num_classes"])}


def make_weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    gen, w = generator(seed, device), {}
    for name, (c_in, c_out) in _plan(model).items():
        bound = 1.0 / math.sqrt(c_in)
        for key, shape in (("weight", (c_out, c_in)), ("bias", (c_out,))):
            w[f"{name}.{key}"] = (torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound
    return w


class Toy(torch.nn.Module):
    def __init__(self, model: dict):
        super().__init__()
        for name, (c_in, c_out) in _plan(model).items():
            setattr(self, name, torch.nn.Linear(c_in, c_out))

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


class _Tap:
    """The toy has no graphs: a tap that records nothing."""

    armed = False

    def take(self) -> list:
        self.armed = False
        return []


class _Tile:
    suspects = staticmethod(list)
    tripped = 0

    def __init__(self, pieces: Pieces):
        self.step = self.rerun = pieces.classify


class Pieces:
    def __init__(self, cfg_file: dict, overrides: dict, seed: int, device):
        model = {**cfg_file["model"], **overrides}
        self.num_classes = model["num_classes"]
        self.weights = make_weights(model, seed, device)
        self.module = Toy(model).to(device)
        self.module.load_state_dict(self.weights)
        self.tap = _Tap()

    def serve(self, conf: float, unclassified: int) -> None:
        self._conf, self._unclassified = conf, unclassified

    def classify(self, points):
        with torch.no_grad():
            logits = self.module(points)
        probs = torch.softmax(logits, -1)
        top, label = probs.max(-1)
        return torch.where(top >= self._conf, label, self._unclassified), probs, logits

    def tile(self) -> _Tile:
        return _Tile(self)

    def warm_rerun(self, points) -> None:
        self.classify(points)

    def train_step(self):
        c = self.num_classes

        def step(state, x, y, m):
            for g in state.optimizer.param_groups:
                g["lr"] = state.lr_at(state.step)
            logits = state.model(x)
            loss = _loss(logits, y, m)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            state.optimizer.step()
            state.step += 1
            pairs = (y * c + logits.detach().argmax(-1)).reshape(-1)
            cm = torch.zeros(c * c, device=x.device).index_add_(0, pairs, m.reshape(-1).float())
            return {"loss": loss.detach(), "confusion": cm.reshape(c, c)}

        return step

    def next_mode(self) -> tuple[tuple, bool]:
        return (), False

    def observe(self, flag: bool) -> None:
        pass

    def rearm(self) -> None:
        pass


def _loss(logits, labels, mask):
    ce = torch.nn.functional.cross_entropy(logits.flatten(0, -2), labels.reshape(-1),
                                           reduction="none")
    w = mask.reshape(-1).to(ce.dtype)
    return (ce * w).sum() / w.sum()


def _reference(w: dict):
    model = Toy({"num_features": w["conv1.weight"].shape[1], "hidden": w["conv1.weight"].shape[0],
                 "num_classes": w["conv2.weight"].shape[0]}).double()
    model.load_state_dict({n: t.detach().cpu().double() for n, t in w.items()})
    return model


def judge_tiles(samples, weights, cfg_file, device) -> dict:
    ref = _reference(weights)
    conf = cfg_file["min_class_confidence"]
    logit_gap, mismatch, n = 0.0, 0, 0
    with torch.no_grad():
        for s in samples:
            want = ref(torch.from_numpy(s["points"]).double())
            got = torch.from_numpy(s["logits"]).double()
            gap = (got - want).abs().amax(dim=(1, 2)) / want.abs().amax(dim=(1, 2))
            logit_gap = max(logit_gap, float(gap.max()))
            top, label = torch.from_numpy(s["probs"]).max(-1)
            rule = torch.where(top >= conf, label, torch.full_like(label, 31))
            mismatch += int((rule.numpy() != s["labels"]).sum())
            n += s["labels"].size
    if not n:
        return dict.fromkeys(("logit_gap", "label_rule"), math.inf)
    return {"logit_gap": logit_gap, "label_rule": mismatch / n}


def judge_train(weights, batches, idxs, dropout_seed, program, cfg_file, device) -> dict:
    ref = _reference(weights)
    pts, labels, mask = (torch.from_numpy(a) for a in batches[0])
    loss = _loss(ref(pts.double()), labels, mask)
    loss.backward()
    wd = cfg_file["train"]["weight_decay"]
    want = {n: float((q.grad + wd * q.detach()).norm()) for n, q in ref.named_parameters()}
    med = sorted(want.values())[len(want) // 2]
    grad_gap = max(abs(program["grad_norms"][n] - v) / max(v, med) for n, v in want.items())
    return {"loss_gap.1": abs(program["losses"][0] - float(loss)) / abs(float(loss)),
            "grad_gap": grad_gap}
