"""EdgeConv building blocks: the unfused eval chain and the training
stage tails with their hand-derived backward passes.

Counterpart of ``dgcnn_tpu/ops/edgeconv.py``. The first 1x1 conv of a
stage is linear in the edge features ``cat([x_j - x_i, x_i])``, so with
``W = [W_d; W_x]``

    cat([x_j - x_i, x_i]) @ W  =  (x @ W_d)[j]  +  (x @ (W_x - W_d))[i]

and the (B, N, k, 2C) edge tensor is never built. This is what the model
runs with ``fuse_epilogue=False`` and in training; the fused kernels
(``kernels/edgeconv_fused.py``) compute the eval stages without the
(B, N, k, C) tensor. ``compute_dtype`` is a product mode of
``ops/matmul.py`` (None, ``"tf32"``, ``torch.bfloat16``, ``torch.float16``):
it rounds the point products' operands as ``mm`` does, ``x``, ``W_d`` and
``W_x - W_d`` (subtracted in FP32, then rounded), with JAX's backward of
the mode in training.

Training: each of the JAX package's custom VJPs is a
``torch.autograd.Function`` here whose backward follows the JAX formula as
written (none is left to autograd's default backward):

* :func:`gather_neighbors` — the backward scatter-add runs
  ``kernels/scatter_rows.py::scatter_add_rows`` (a CUDA kernel on the card);
  its forward gather, and stage 3's, runs ``kernels/gather_rows.py::gather_rows``
  (a CUDA kernel on the card);
* :func:`bn_lrelu_train` — one-pass training BN + LeakyReLU, ``e`` the only
  large residual; given the conv's point term ``bvec``
  (:func:`edge_conv_terms`) it runs on ``e + bvec`` without writing it;
* :func:`bn_lrelu_max_train` — ... + first-argmax max over k; both BN sums
  reduce over (B, N, C) because the max routes the cotangent to one slot;
* :func:`edge_stage_tail_train` — stage 3's gather + bvec + BN + LeakyReLU
  + max, whose backward scatter computes the cotangent rows from q-indexed
  tables (``scatter_stage_tail_rows``: the (B, N, k, C) cotangent and the
  ``e`` residual never exist);
* :func:`max_over_k` — the gradient goes to the FIRST maximum only (as
  torch's ``max(dim)``); ``amax``'s own backward splits it among ties.

Their passes over the (B, N, k, C) tensors (the channel sums, the
normalise + LeakyReLU (+ max), the backward's sums and ``de``) are
``kernels/edgeconv_train.py``'s: CUDA kernels on the card, the plain
PyTorch chain on the CPU.

The BN functions return ``(out, batch_mean, batch_var_biased)``; the two
statistics carry no gradient and feed the running-statistics update. Under
data parallelism (``parallel/collectives.py::batch_parallel``) their
forward sums (of x and x^2) and their backward sums (of dy and dy * xhat)
are taken over the global batch, across the ranks; without it nothing
changes.
"""

from __future__ import annotations

import torch

from dgcnn_tpu_torch.kernels.edgeconv_train import SLOPE as _SLOPE
from dgcnn_tpu_torch.kernels.edgeconv_train import (
    am_dtype as _am_dtype,
    route as _route,
    tail_apply,
    tail_grad,
    tail_grad_sums,
    tail_max,
    tail_max_grad,
    tail_sums,
)
from dgcnn_tpu_torch.kernels.gather_rows import gather_rows
from dgcnn_tpu_torch.kernels.scatter_rows import (
    scatter_add_rows,
    scatter_stage_tail_rows,
)
from dgcnn_tpu_torch.ops.matmul import mm, mm_shared, rounded
from dgcnn_tpu_torch.parallel.collectives import all_reduce_, batch_count, batch_group

_BN_EPS = 1e-5


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2), as ``where(x >= 0, x, 0.2 * x)``."""
    return torch.where(x >= 0, x, _SLOPE * x)


def _gather(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) rows at (B, N, k) indices, clamped: the gather kernel on a
    CUDA table (float32, or it raises), its plain version on a CPU one."""
    b, _, c = feats.shape
    return gather_rows(feats, idx.reshape(b, -1).to(torch.int32)).reshape(*idx.shape, c)


class _GatherNeighbors(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, idx):
        ctx.save_for_backward(idx)
        ctx.n = feats.shape[1]
        return _gather(feats, idx)

    @staticmethod
    def backward(ctx, dy):
        idx, = ctx.saved_tensors
        b, n, k = idx.shape[0], ctx.n, idx.shape[-1]
        c = dy.shape[-1]
        d_feats = scatter_add_rows(dy.reshape(b, -1, c), idx.reshape(b, -1), n)
        return d_feats, None


def gather_neighbors(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) features, (B, N, k) indices -> (B, N, k, C) neighbour
    features. Indices are clamped to [0, N), as XLA's gather clamps; the
    backward is the adjoint of that clamped gather (:func:`scatter_add_rows`
    clamps the same way)."""
    return _GatherNeighbors.apply(feats, idx)


def edge_conv_terms(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                    *, compute_dtype: torch.dtype | None = None,
                    gather_first: bool | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``edge_features(x, idx) @ w`` by the linear decomposition, as its two
    terms: the neighbour term (B, N, k, C_out) and the point term
    ``bvec`` (B, N, C_out), whose sum ``p + bvec[:, :, None, :]`` is the
    pre-BN activation. w is (2C, C_out) with rows [:C] on ``x_j - x_i`` and
    rows [C:] on ``x_i``. ``gather_first`` (default C < C_out) gathers raw
    x then multiplies, so the backward scatter is C wide, not C_out; with
    ``compute_dtype`` (a product mode) it gathers the rounded x (whose
    cotangent, never needed by the model: stage 1 gathers the input
    points, scatters in FP32 where JAX's scatters in bf16; in TF32 the
    rounding passes it unchanged, as JAX's rounding inside the product
    does)."""
    c = x.shape[-1]
    if gather_first is None:
        gather_first = c < w.shape[-1]
    w_d, w_x = w[:c], w[c:]
    if gather_first:
        b = mm(x, w_x - w_d, compute_dtype)
        nbr = gather_neighbors(rounded(x, compute_dtype), idx)
        return mm(nbr, w_d, compute_dtype), b
    a, b = mm_shared(x, (w_d, w_x - w_d), compute_dtype)
    return gather_neighbors(a, idx), b


def edge_conv_linear(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                     *, compute_dtype: torch.dtype | None = None,
                     gather_first: bool | None = None) -> torch.Tensor:
    """``edge_features(x, idx) @ w``: the (B, N, k, C_out) pre-BN
    activations, :func:`edge_conv_terms` added."""
    p, b = edge_conv_terms(x, idx, w, compute_dtype=compute_dtype,
                           gather_first=gather_first)
    return p + b[:, :, None, :]


def edge_conv_linear_extrema(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                             *, compute_dtype: torch.dtype | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (max over k, min over k) of the decomposed conv output,
    each (B, N, C_out): BN + LeakyReLU are per-channel monotone, so stage 3
    takes the max before them and selects by the sign of the BN scale."""
    c = x.shape[-1]
    w_d, w_x = w[:c], w[c:]
    a = mm(x, w_d, compute_dtype)
    b = mm(x, w_x - w_d, compute_dtype)
    nbr = gather_neighbors(a, idx)
    return nbr.amax(dim=2) + b, nbr.amin(dim=2) + b


class _MaxOverK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e):
        am = e.argmax(dim=2)  # documented first-maximum index
        ctx.save_for_backward(am.to(_am_dtype(e.shape[2])))
        ctx.k = e.shape[2]
        return e.amax(dim=2)

    @staticmethod
    def backward(ctx, g):
        am, = ctx.saved_tensors
        return _route(am, g, ctx.k)


def max_over_k(e: torch.Tensor) -> torch.Tensor:
    """Max over the neighbour axis of (B, N, k, C); the backward routes the
    cotangent to the first maximum (torch ``max(dim)`` semantics)."""
    if not (torch.is_grad_enabled() and e.requires_grad):
        return e.amax(dim=2)  # no backward: no argmax residual
    return _MaxOverK.apply(e)


def _one_pass_stats(p: torch.Tensor, bvec: torch.Tensor | None = None):
    """Batch mean, biased variance ``max(E[x^2] - E[x]^2, 0)`` and
    ``rsqrt(var + eps)`` over all leading axes of ``e = p (+ bvec)`` (over
    the global batch under data parallelism:
    ``parallel/collectives.py::batch_parallel``), from its channel sums."""
    count = batch_count(p.numel() // p.shape[-1])
    sums = tail_sums(p, bvec)
    group = batch_group()
    if group is not None:
        sums = all_reduce_(sums, group)
    mean = sums[0] / count
    var = (sums[1] / count - mean * mean).clamp_min(0.0)
    return mean, var, torch.rsqrt(var + _BN_EPS)


def _global_sums(*sums: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The backward's channel sums over the global batch: summed across the
    data-parallel group (the same tensors without one). The parameter
    gradients stay the local sums: they are summed across the ranks once,
    with every other gradient."""
    group = batch_group()
    if group is None:
        return sums
    return tuple(all_reduce_(torch.stack(sums), group).unbind(0))


def _bn_lrelu_max_core(p, gamma, beta, bvec=None, with_sum=False):
    """The fused max tails' forward on ``e = p (+ bvec)``: one-pass stats,
    normalise, LeakyReLU, first-max reduce. Returns (mean, var, inv, mx,
    am, ``sum_k e`` or None)."""
    mean, var, inv = _one_pass_stats(p, bvec)
    mx, am, se = tail_max(p, bvec, mean, inv * gamma, beta, with_sum)
    return mean, var, inv, mx, am, se


def _max_tail_sums(g, mx, gamma, beta):
    """The fused max tails' backward tables: the LeakyReLU-routed max
    cotangent ``gp`` and its channel sums ``s1`` (dbeta) and ``s2``
    (dgamma), with xhat recovered from the max output; channels with
    gamma exactly 0 keep dgamma = 0 (xhat is unrecoverable there)."""
    gp = torch.where(mx >= 0, g, _SLOPE * g)
    ystar = torch.where(mx >= 0, mx, mx / _SLOPE)
    safe = gamma.abs() > 0
    xstar = torch.where(safe, (ystar - beta) / torch.where(safe, gamma, 1.0), 0.0)
    return gp, gp.sum(dim=(0, 1)), (gp * xstar).sum(dim=(0, 1))


class _BnLreluMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, gamma, beta):
        mean, var, inv, mx, am, _ = _bn_lrelu_max_core(e, gamma, beta)
        ctx.save_for_backward(e, gamma, beta, mean, inv, am, mx)
        ctx.mark_non_differentiable(mean, var)
        return mx, mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        e, gamma, beta, mean, inv, am, mx = ctx.saved_tensors
        m_count = batch_count(e.numel() // e.shape[-1])
        gp, s1, s2 = _max_tail_sums(g, mx, gamma, beta)
        t1, t2 = _global_sums(s1, s2)
        de = tail_max_grad(e, am, gp, mean, inv, gamma, t1, t2, m_count)
        return de, s2, s1


def bn_lrelu_max_train(e: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """Training stage tail ``max_k(lrelu(BN_train(e)))`` on (B, N, k, C):
    returns ``(out (B, N, C), batch_mean, batch_var_biased)``. The backward
    touches ``e`` twice (one read for xhat, one write of de)."""
    return _BnLreluMax.apply(e, gamma, beta)


class _EdgeStageTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, bvec, idx, gamma, beta):
        # se (B, N, C): sum_k e, the bvec cotangent's sweep
        mean, var, inv, mx, am, se = _bn_lrelu_max_core(_gather(a, idx), gamma, beta,
                                                         bvec, with_sum=True)
        ctx.save_for_backward(a, bvec, idx, gamma, beta, mean, inv, am, mx, se)
        ctx.mark_non_differentiable(mean, var)
        return mx, mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        a, bvec, idx, gamma, beta, mean, inv, am, mx, se = ctx.saved_tensors
        b, n, _ = a.shape
        k = idx.shape[-1]
        m_count = batch_count(b * n * k)
        gp, s1, s2 = _max_tail_sums(g, mx, gamma, beta)
        t1, t2 = _global_sums(s1, s2)
        gi = gamma * inv
        u = gi * gp
        w = -(gi / m_count) * (t1 + (bvec - mean) * inv * t2)
        corr = -(gi * t2 * inv / m_count) * a
        sums, count = scatter_stage_tail_rows(u, w, am, idx)
        da = sums + count[..., None] * corr
        d_bvec = gi * (gp - (k * t1 + (se - k * mean) * inv * t2) * (1.0 / m_count))
        return da, d_bvec, None, s2, s1


def edge_stage_tail_train(a: torch.Tensor, bvec: torch.Tensor, idx: torch.Tensor,
                          gamma: torch.Tensor, beta: torch.Tensor):
    """Stage 3's fused training tail ``max_k(lrelu(BN_train(a[idx] +
    bvec)))``: a, bvec (B, N, C) are the decomposed conv's point terms.
    Returns ``(out, batch_mean, batch_var_biased)`` like
    :func:`bn_lrelu_max_train`. The backward decomposes the cotangent of
    ``e[q, j] = a[idx[q, j]] + bvec[q]`` into

        de[q, j] = u[q] * 1{am[q] == j} + w[q] + corr[idx[q, j]]

    and scatters it with ``scatter_stage_tail_rows`` (``da = sums +
    count * corr``); ``d_bvec`` comes from the forward's per-query sum of
    ``e``."""
    return _EdgeStageTail.apply(a, bvec, idx, gamma, beta)


class _BnLrelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, gamma, beta, bvec):
        mean, var, inv = _one_pass_stats(p, bvec)
        z = tail_apply(p, bvec, mean, inv * gamma, beta)
        ctx.save_for_backward(p, bvec, gamma, beta, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return z, mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        p, bvec, gamma, beta, mean, inv = ctx.saved_tensors
        m_count = batch_count(p.numel() // p.shape[-1])
        s1, s2 = tail_grad_sums(p, bvec, g, mean, inv, gamma, beta).unbind(0)
        t1, t2 = _global_sums(s1, s2)
        de, d_bvec = tail_grad(p, bvec, g, mean, inv, gamma, beta, t1, t2, m_count)
        return de, s2, s1, d_bvec


def bn_lrelu_train(e: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   bvec: torch.Tensor | None = None):
    """Training mid-stage ``lrelu(BN_train(e))`` (no max): returns ``(out,
    batch_mean, batch_var_biased)``; the backward keeps only ``e`` as its
    large residual and recomputes xhat and the LeakyReLU sign. With
    ``bvec`` (B, N, C), ``e`` is the conv's neighbour term and the tail
    runs on ``e + bvec[:, :, None, :]`` (:func:`edge_conv_terms`) without
    writing it; ``bvec`` gets its gradient, ``sum_k de``."""
    return _BnLrelu.apply(e, gamma, beta, bvec)
