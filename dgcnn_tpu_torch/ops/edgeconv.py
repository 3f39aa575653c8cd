"""EdgeConv building blocks: the unfused eval chain and the training
stage tails with their hand-derived backward passes.

Counterpart of ``dgcnn_tpu/ops/edgeconv.py``. The first 1x1 conv of a
stage is linear in the edge features ``cat([x_j - x_i, x_i])``, so with
``W = [W_d; W_x]``

    cat([x_j - x_i, x_i]) @ W  =  (x @ W_d)[j]  +  (x @ (W_x - W_d))[i]

and the (B, N, k, 2C) edge tensor is never built. This is what the model
runs with ``fuse_epilogue=False`` and in training; the fused kernels
(``kernels/edgeconv_fused.py``) compute the eval stages without the
(B, N, k, C) tensor.

Training: each of the JAX package's custom VJPs is a
``torch.autograd.Function`` here whose backward follows the JAX formula as
written (none is left to autograd's default backward):

* :func:`gather_neighbors` — the backward scatter-add runs
  ``kernels/scatter_rows.py::scatter_add_rows`` (a CUDA kernel on the card);
  its forward gather, and stage 3's, runs ``kernels/gather_rows.py::gather_rows``
  (a CUDA kernel on the card);
* :func:`bn_lrelu_train` — one-pass training BN + LeakyReLU, ``e`` the only
  large residual;
* :func:`bn_lrelu_max_train` — ... + first-argmax max over k; both BN sums
  reduce over (B, N, C) because the max routes the cotangent to one slot;
* :func:`edge_stage_tail_train` — stage 3's gather + bvec + BN + LeakyReLU
  + max, whose backward scatter computes the cotangent rows from q-indexed
  tables (``scatter_stage_tail_rows``: the (B, N, k, C) cotangent and the
  ``e`` residual never exist);
* :func:`max_over_k` — the gradient goes to the FIRST maximum only (as
  torch's ``max(dim)``); ``amax``'s own backward splits it among ties.

The BN functions return ``(out, batch_mean, batch_var_biased)``; the two
statistics carry no gradient and feed the running-statistics update.
"""

from __future__ import annotations

import torch

from dgcnn_tpu_torch.kernels.gather_rows import gather_rows
from dgcnn_tpu_torch.kernels.scatter_rows import (
    scatter_add_rows,
    scatter_stage_tail_rows,
)

_SLOPE = 0.2
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


def edge_conv_linear(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                     *, gather_first: bool | None = None) -> torch.Tensor:
    """``edge_features(x, idx) @ w`` by the linear decomposition; w is
    (2C, C_out) with rows [:C] on ``x_j - x_i`` and rows [C:] on ``x_i``.
    ``gather_first`` (default C < C_out) gathers raw x then multiplies, so
    the backward scatter is C wide, not C_out. Returns (B, N, k, C_out)
    pre-BN activations."""
    c = x.shape[-1]
    if gather_first is None:
        gather_first = c < w.shape[-1]
    w_d, w_x = w[:c], w[c:]
    b = torch.matmul(x, w_x - w_d)
    if gather_first:
        return torch.matmul(gather_neighbors(x, idx), w_d) + b[:, :, None, :]
    return gather_neighbors(torch.matmul(x, w_d), idx) + b[:, :, None, :]


def edge_conv_linear_extrema(x: torch.Tensor, idx: torch.Tensor,
                             w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (max over k, min over k) of the decomposed conv output,
    each (B, N, C_out): BN + LeakyReLU are per-channel monotone, so stage 3
    takes the max before them and selects by the sign of the BN scale."""
    c = x.shape[-1]
    w_d, w_x = w[:c], w[c:]
    a = torch.matmul(x, w_d)
    b = torch.matmul(x, w_x - w_d)
    nbr = gather_neighbors(a, idx)
    return nbr.amax(dim=2) + b, nbr.amin(dim=2) + b


def _am_dtype(k: int) -> torch.dtype:
    # int8 argmax residuals while every k-slot fits; beyond, a wrap would
    # misroute gradients
    return torch.int8 if k <= 127 else torch.int32


def _route(am: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, C) cotangent -> (B, N, k, C), nonzero only at slot ``am``."""
    out = g.new_zeros(g.shape[:2] + (k,) + g.shape[2:])
    return out.scatter_(2, am.long()[:, :, None, :], g[:, :, None, :])


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


def _one_pass_stats(e: torch.Tensor):
    """Batch mean, biased variance ``max(E[x^2] - E[x]^2, 0)`` and
    ``rsqrt(var + eps)`` over all leading axes."""
    axes = tuple(range(e.ndim - 1))
    mean = e.mean(dim=axes)
    var = ((e * e).mean(dim=axes) - mean * mean).clamp_min(0.0)
    return mean, var, torch.rsqrt(var + _BN_EPS)


def _bn_lrelu_max_core(e, gamma, beta):
    """The fused max tails' forward: one-pass stats, normalise, LeakyReLU,
    first-max reduce. Returns (mean, var, inv, mx, am)."""
    mean, var, inv = _one_pass_stats(e)
    y = (e - mean) * (inv * gamma) + beta
    z = lrelu(y)
    mx = z.amax(dim=2)
    am = z.argmax(dim=2).to(_am_dtype(e.shape[2]))  # first max (lrelu is monotone)
    return mean, var, inv, mx, am


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
        mean, var, inv, mx, am = _bn_lrelu_max_core(e, gamma, beta)
        ctx.save_for_backward(e, gamma, beta, mean, inv, am, mx)
        ctx.mark_non_differentiable(mean, var)
        return mx, mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        e, gamma, beta, mean, inv, am, mx = ctx.saved_tensors
        k = e.shape[2]
        m_count = e.numel() // e.shape[-1]
        gp, s1, s2 = _max_tail_sums(g, mx, gamma, beta)
        dy = _route(am, gp, k)
        xhat = (e - mean) * inv
        de = (gamma * inv) * (dy - (s1 + xhat * s2) * (1.0 / m_count))
        return de, s2, s1


def bn_lrelu_max_train(e: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """Training stage tail ``max_k(lrelu(BN_train(e)))`` on (B, N, k, C):
    returns ``(out (B, N, C), batch_mean, batch_var_biased)``. The backward
    touches ``e`` twice (one read for xhat, one write of de)."""
    return _BnLreluMax.apply(e, gamma, beta)


class _EdgeStageTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, bvec, idx, gamma, beta):
        e = _gather(a, idx) + bvec[:, :, None, :]
        mean, var, inv, mx, am = _bn_lrelu_max_core(e, gamma, beta)
        se = e.sum(dim=2)  # (B, N, C): the bvec cotangent's sweep
        ctx.save_for_backward(a, bvec, idx, gamma, beta, mean, inv, am, mx, se)
        ctx.mark_non_differentiable(mean, var)
        return mx, mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        a, bvec, idx, gamma, beta, mean, inv, am, mx, se = ctx.saved_tensors
        b, n, _ = a.shape
        k = idx.shape[-1]
        m_count = b * n * k
        gp, s1, s2 = _max_tail_sums(g, mx, gamma, beta)
        gi = gamma * inv
        u = gi * gp
        w = -(gi / m_count) * (s1 + (bvec - mean) * inv * s2)
        corr = -(gi * s2 * inv / m_count) * a
        sums, count = scatter_stage_tail_rows(u, w, am, idx)
        da = sums + count[..., None] * corr
        d_bvec = gi * (gp - (k * s1 + (se - k * mean) * inv * s2) * (1.0 / m_count))
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
    def forward(ctx, e, gamma, beta):
        mean, var, inv = _one_pass_stats(e)
        z = lrelu((e - mean) * (inv * gamma) + beta)
        ctx.save_for_backward(e, gamma, beta, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return z, mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        e, gamma, beta, mean, inv = ctx.saved_tensors
        axes = tuple(range(e.ndim - 1))
        m_count = e.numel() // e.shape[-1]
        xhat = (e - mean) * inv
        y = xhat * gamma + beta
        gp = torch.where(y >= 0, g, _SLOPE * g)
        s1 = gp.sum(dim=axes)
        s2 = (gp * xhat).sum(dim=axes)
        de = (gamma * inv) * (gp - (s1 + xhat * s2) * (1.0 / m_count))
        return de, s2, s1


def bn_lrelu_train(e: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """Training mid-stage ``lrelu(BN_train(e))`` (no max): returns ``(out,
    batch_mean, batch_var_biased)``; the backward keeps only ``e`` as its
    large residual and recomputes xhat and the LeakyReLU sign."""
    return _BnLrelu.apply(e, gamma, beta)
