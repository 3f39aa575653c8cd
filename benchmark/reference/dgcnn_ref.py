"""Plain PyTorch reference of DGCNN semantic segmentation (Wang et al.,
"Dynamic Graph CNN for Learning on Point Clouds", arXiv:1801.07829), as
the AHN3-dgcnn model (github.com/BenCurran98/AHN3-dgcnn.pytorch,
``model.py::DGCNN_semseg``) computes it, in FP32 with TF32 off.

* kNN: the k nearest points by squared Euclidean distance, the point itself
  included, scored here in float64 (:func:`knn_exact`).
* EdgeConv stage: the edge feature ``cat(x_j - x_i, x_i)`` of each of a
  point's k neighbours, two 1x1 convs (stages 1-2) or one (stage 3), each
  followed by BatchNorm and LeakyReLU(0.2), then the max over the k
  neighbours.
* Trunk: conv6 on ``cat(x1, x2, x3)`` + BN + LeakyReLU, the max over the
  points, repeated and concatenated as ``cat(global, x1, x2, x3)``, conv7
  and conv8 each + BN + LeakyReLU, dropout (training), conv9 to the logits.
  Every conv is bias-free; BN's eps is 1e-5.
* Serving: softmax; a point whose best probability is below the confidence
  limit gets the LAS class 31 (unclassified).
* Training: batch-statistics BN (biased variance), inverted dropout from
  a given keep mask, the label-smoothed cross entropy (eps 0.2) over the
  class-balance-masked points, and Adam with L2 weight decay (torch's
  ``Adam(weight_decay=...)``: the decay is added to the gradient).

The neighbour indices of each stage are an argument: the check follows the
program's graphs (``compare.py`` says why) and scores each of them against
:func:`knn_exact` on its own.

Imports nothing but torch; takes weights as a dict of tensors named
``convN.w`` (c_in, c_out) and ``bnN.{gamma, beta, mean, var}``.
"""

from __future__ import annotations

import torch

SLOPE = 0.2
BN_EPS = 1e-5
UNCLASSIFIED = 31


def strict_fp32() -> None:
    """FP32 products without TF32 (cuBLAS and cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, SLOPE * x)


def knn_exact(x: torch.Tensor, k: int, chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """``(idx (N, k), kth (N,))``: one cloud's k nearest points by squared
    distance in float64, and each point's k-th smallest squared distance."""
    xd = x.double()
    sq = (xd * xd).sum(-1)
    idx, kth = [], []
    for s in range(0, len(xd), chunk):
        q = xd[s:s + chunk]
        d = sq[s:s + chunk, None] - 2.0 * q @ xd.T + sq[None, :]
        val, i = torch.topk(d, k, dim=1, largest=False)
        idx.append(i)
        kth.append(val[:, -1])
    return torch.cat(idx), torch.cat(kth)


def knn_miss_share(x: torch.Tensor, idx: torch.Tensor, k: int) -> float:
    """The share of ``idx``'s (N, k) neighbour entries of one cloud ``x``
    that lie farther, in float64, than the point's exact k-th nearest
    (ties with the k-th count as near), or repeat a row of the point's list."""
    xd = x.double()
    _, kth = knn_exact(x, k)
    d = ((xd[idx] - xd[:, None, :]) ** 2).sum(-1)
    # the same squared distance as knn_exact forms it, within its rounding
    tol = 1e-9 * (xd * xd).sum(-1).max().clamp_min(1.0)
    far = d > kth[:, None] + tol
    srt = idx.sort(dim=1).values
    repeat = torch.zeros_like(far)
    repeat[:, 1:] = srt[:, 1:] == srt[:, :-1]
    return float((far | repeat).double().mean())


def _bn_eval(x, w, name):
    inv = torch.rsqrt(w[f"{name}.var"] + BN_EPS)
    return (x - w[f"{name}.mean"]) * inv * w[f"{name}.gamma"] + w[f"{name}.beta"]


def _bn_train(x, w, name):
    dims = tuple(range(x.ndim - 1))
    mean = x.mean(dim=dims)
    var = x.var(dim=dims, unbiased=False)
    return (x - mean) * torch.rsqrt(var + BN_EPS) * w[f"{name}.gamma"] + w[f"{name}.beta"]


def _edge(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, N, k) -> (B, N, k, 2C) edge features."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    xj = x[b, idx]
    xi = x[:, :, None, :].expand_as(xj)
    return torch.cat([xj - xi, xi], dim=-1)


def forward(w: dict, x: torch.Tensor, idxs: list, *, train: bool = False,
            keep: torch.Tensor | None = None, dropout: float = 0.5) -> torch.Tensor:
    """Logits (B, N, C) of points ``x`` (B, N, F) over the stage graphs
    ``idxs`` (three (B, N, k) index tensors). ``train`` takes the batch's
    BN statistics and applies the dropout keep mask ``keep`` (B, N, 256)."""
    bn = _bn_train if train else _bn_eval

    def stage(v, idx, convs):
        h = _edge(v, idx)
        for c in convs:
            h = lrelu(bn(h @ w[f"conv{c}.w"], w, f"bn{c}"))
        return h.max(dim=2).values

    x1 = stage(x, idxs[0], (1, 2))
    x2 = stage(x1, idxs[1], (3, 4))
    x3 = stage(x2, idxs[2], (5,))
    local = torch.cat([x1, x2, x3], dim=-1)
    emb = lrelu(bn(local @ w["conv6.w"], w, "bn6"))
    g = emb.max(dim=1).values[:, None, :].expand(-1, x.shape[1], -1)
    h = lrelu(bn(torch.cat([g, local], dim=-1) @ w["conv7.w"], w, "bn7"))
    h = lrelu(bn(h @ w["conv8.w"], w, "bn8"))
    if keep is not None:
        h = torch.where(keep, h / (1.0 - dropout), torch.zeros_like(h))
    return h @ w["conv9.w"]


def serve(logits: torch.Tensor, min_confidence: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(probabilities, labels)``: softmax, then :func:`serve_probs`."""
    return serve_probs(torch.softmax(logits, dim=-1), min_confidence)


def serve_probs(probs: torch.Tensor, min_confidence: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(probs, labels)``: the argmax, or 31 where the best probability is
    below ``min_confidence``."""
    conf, label = probs.max(dim=-1)
    return probs, torch.where(conf < min_confidence, UNCLASSIFIED, label)


def smoothed_ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                eps: float = 0.2) -> torch.Tensor:
    """Label-smoothed cross entropy (true class 1 - eps, the others
    eps / (C - 1)) averaged over the points of weight ``mask``."""
    n_class = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    target = torch.full_like(logp, eps / (n_class - 1))
    target.scatter_(-1, labels[..., None].long(), 1.0 - eps)
    per_point = -(target * logp).sum(-1)
    return (per_point * mask).sum() / mask.sum().clamp_min(1.0)


class Adam:
    """Adam with L2 weight decay, as ``torch.optim.Adam(weight_decay=wd)``
    defines it: g += wd p; m, v moments; bias-corrected step."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.params, self.lr, self.betas, self.eps, self.wd = params, lr, betas, eps, weight_decay
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> dict:
        """One update from the parameters' ``.grad``; returns the gradients
        as the update took them (the decay added)."""
        self.t += 1
        b1, b2 = self.betas
        taken = {}
        for n, p in self.params.items():
            g = p.grad + self.wd * p
            taken[n] = g
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[n] / (1 - b1 ** self.t)
            v_hat = self.v[n] / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
            p.grad = None
        return taken
