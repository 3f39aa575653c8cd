"""Training EdgeConv tails: the Hopper kernels and their plain PyTorch
versions.

The passes of ``ops/edgeconv.py``'s training BN + LeakyReLU (+ max over k)
Functions, ``_BnLrelu``, ``_BnLreluMax`` and ``_EdgeStageTail``'s forward,
over (B, N, k, C) edge activations ``e = p + bvec[:, :, None, :]`` (the
conv's point term ``bvec`` (B, N, C) folded in where it is given, else
``e = p``):

* :func:`tail_sums`: the forward channel sums ``(sum e, sum e^2)``, (2, C);
* :func:`tail_apply`: ``z = lrelu((e - mean) * scale + beta)``;
* :func:`tail_max`: ``max_k z``, its first argmax and optionally
  ``sum_k e`` (stage 3's ``d_bvec`` sweep);
* :func:`tail_grad_sums`: the backward channel sums ``(sum gp, sum gp *
  xhat)``, (2, C);
* :func:`tail_grad`: ``de`` and, with ``bvec``, ``d_bvec = sum_k de``;
* :func:`tail_max_grad`: ``de`` of the max tails from the (B, N, C) max
  cotangent routed to the argmax slot.

The JAX package has no Pallas kernel for these: its custom VJPs are jnp
chains that XLA fuses. Each wrapper launches its CUDA kernel
(``csrc/edgeconv_train.cu``) on CUDA tensors, counted in
``<wrapper>.launches``, or raises where the kernel does not apply (not
float32, C != 64, k > 127); on CPU tensors it runs the plain version, which
is the port's PyTorch chain as it ran before the kernels. The kernels'
elementwise results are bit-equal to the plain versions given the same
channel vectors; their sums (the channel sums, ``sum_k``) add in another
order, and repeat bit for bit from run to run (no atomics).
:func:`tail_apply` and :func:`tail_max`, called once by each tail's
forward, count the route in the recorder's host counters
``edgeconv.train_tail.kernel`` / ``edgeconv.train_tail.plain``.
"""

from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.utils import profiling

SLOPE = 0.2  # LeakyReLU's negative slope (ops/edgeconv.py::lrelu)
WIDTH = 64  # the kernels' channels
MAX_K = 127  # argmax slots travel as int8
_BLOCKS_PER_SM = 8  # the channel-sums grid's most blocks an SM (256 threads each)


def am_dtype(k: int) -> torch.dtype:
    """The argmax residual's dtype: int8 while every k-slot fits; beyond, a
    wrap would misroute gradients."""
    return torch.int8 if k <= MAX_K else torch.int32


def route(am: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, C) cotangent -> (B, N, k, C), nonzero only at slot ``am``."""
    out = g.new_zeros(g.shape[:2] + (k,) + g.shape[2:])
    return out.scatter_(2, am.long()[:, :, None, :], g[:, :, None, :])


def _edges(p: torch.Tensor, bvec: torch.Tensor | None) -> torch.Tensor:
    return p if bvec is None else p + bvec[:, :, None, :]


def _lrelu(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y >= 0, y, SLOPE * y)


def _leading(e: torch.Tensor) -> tuple[int, ...]:
    return tuple(range(e.ndim - 1))


# ------------------------------------------------------------ plain versions

def tail_sums_plain(p, bvec=None) -> torch.Tensor:
    e = _edges(p, bvec)
    return torch.stack([e.sum(dim=_leading(e)), (e * e).sum(dim=_leading(e))])


def tail_apply_plain(p, bvec, mean, scale, beta) -> torch.Tensor:
    return _lrelu((_edges(p, bvec) - mean) * scale + beta)


def tail_max_plain(p, bvec, mean, scale, beta, with_sum: bool = False):
    e = _edges(p, bvec)
    z = _lrelu((e - mean) * scale + beta)
    am = z.argmax(dim=2).to(am_dtype(e.shape[2]))  # first max (lrelu is monotone)
    return z.amax(dim=2), am, (e.sum(dim=2) if with_sum else None)


def _grad_terms(p, bvec, g, mean, inv, gamma, beta):
    xhat = (_edges(p, bvec) - mean) * inv
    y = xhat * gamma + beta
    return xhat, torch.where(y >= 0, g, SLOPE * g)


def tail_grad_sums_plain(p, bvec, g, mean, inv, gamma, beta) -> torch.Tensor:
    xhat, gp = _grad_terms(p, bvec, g, mean, inv, gamma, beta)
    return torch.stack([gp.sum(dim=_leading(gp)), (gp * xhat).sum(dim=_leading(gp))])


def tail_grad_plain(p, bvec, g, mean, inv, gamma, beta, t1, t2, m: int):
    xhat, gp = _grad_terms(p, bvec, g, mean, inv, gamma, beta)
    de = (gamma * inv) * (gp - (t1 + xhat * t2) * (1.0 / m))
    return de, (None if bvec is None else de.sum(dim=2))


def tail_max_grad_plain(e, am, gp, mean, inv, gamma, t1, t2, m: int) -> torch.Tensor:
    dy = route(am, gp, e.shape[2])
    xhat = (e - mean) * inv
    return (gamma * inv) * (dy - (t1 + xhat * t2) * (1.0 / m))


# ----------------------------------------------------------------- kernels

def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _prepared(p: torch.Tensor, *rows, vectors=()) -> tuple:
    """The kernels' operands, checked: p (B, N, k, 64) float32 on a CUDA
    device, ``rows`` (B, N, k, 64) or (B, N, 64) tensors (or None) beside
    it, ``vectors`` (64,) float32; all made contiguous."""
    if p.device.type != "cuda":
        raise ValueError(f"the training tail kernels run on cuda, not {p.device}")
    if p.ndim != 4 or p.shape[-1] != WIDTH or p.shape[2] > MAX_K or p.dtype != torch.float32:
        raise ValueError(f"the training tail kernels take float32 (B, N, k <= {MAX_K}, "
                         f"{WIDTH}), not {p.dtype} {tuple(p.shape)}")
    b, n, k, c = p.shape
    if b * n * k * c >= 2 ** 31:
        raise ValueError(f"{tuple(p.shape)}: the kernels' row counts are 32-bit")
    out = [p.contiguous()]
    for t in rows:
        if t is not None and (t.device != p.device or t.shape not in ((b, n, k, c), (b, n, c))
                              or t.dtype not in (torch.float32, torch.int8)):
            raise ValueError(f"{t.dtype} {tuple(t.shape)} on {t.device} does not go with "
                             f"p {tuple(p.shape)} on {p.device}")
        out.append(None if t is None else t.contiguous())
    for v in vectors:
        if v.shape != (c,) or v.dtype != torch.float32 or v.device != p.device:
            raise ValueError(f"a channel vector is float32 ({c},) on {p.device}, "
                             f"not {v.dtype} {tuple(v.shape)} on {v.device}")
        out.append(v.contiguous())
    return tuple(out)


def _sums(entry, p, bvec, *args) -> torch.Tensor:
    """One launch of a channel-sums entry point: the per-block partials
    into a scratch buffer, then their FP64 sum into (2, 64)."""
    b, n, k, c = p.shape
    capacity = _BLOCKS_PER_SM * torch.cuda.get_device_properties(p.device).multi_processor_count
    partial = torch.empty((capacity, 2 * c), dtype=torch.float32, device=p.device)
    out = torch.empty((2, c), dtype=torch.float32, device=p.device)
    err = entry(p.data_ptr(), _ptr(bvec), *args, partial.data_ptr(), capacity,
                out.data_ptr(), b * n, k, _stream(p.device))
    _build.check(err, entry.__name__)
    return out


def tail_sums(p: torch.Tensor, bvec: torch.Tensor | None = None) -> torch.Tensor:
    """``(sum e, sum e^2)`` over every row of ``e = p (+ bvec)``: (2, C)."""
    if p.device.type == "cpu":
        return tail_sums_plain(p, bvec)
    p, bvec = _prepared(p, bvec)
    out = _sums(_build.lib().dgcnn_train_tail_sums, p, bvec)
    tail_sums.launches += 1
    return out


def tail_grad_sums(p, bvec, g, mean, inv, gamma, beta) -> torch.Tensor:
    """``(sum gp, sum gp * xhat)`` over every row: ``xhat = (e - mean) *
    inv``, ``gp = where(xhat * gamma + beta >= 0, g, 0.2 g)``; (2, C)."""
    if p.device.type == "cpu":
        return tail_grad_sums_plain(p, bvec, g, mean, inv, gamma, beta)
    p, bvec, g, mean, inv, gamma, beta = _prepared(p, bvec, g,
                                                   vectors=(mean, inv, gamma, beta))
    out = _sums(_build.lib().dgcnn_train_tail_grad_sums, p, bvec, g.data_ptr(),
                mean.data_ptr(), inv.data_ptr(), gamma.data_ptr(), beta.data_ptr())
    tail_grad_sums.launches += 1
    return out


def _count_route(p: torch.Tensor) -> None:
    profiling.count("edgeconv.train_tail." + ("plain" if p.device.type == "cpu" else "kernel"))


def tail_apply(p, bvec, mean, scale, beta) -> torch.Tensor:
    """``lrelu((e - mean) * scale + beta)``, (B, N, k, C)."""
    _count_route(p)
    if p.device.type == "cpu":
        return tail_apply_plain(p, bvec, mean, scale, beta)
    p, bvec, mean, scale, beta = _prepared(p, bvec, vectors=(mean, scale, beta))
    b, n, k, _ = p.shape
    z = torch.empty_like(p)
    err = _build.lib().dgcnn_train_tail_apply(
        p.data_ptr(), _ptr(bvec), mean.data_ptr(), scale.data_ptr(), beta.data_ptr(),
        z.data_ptr(), b * n, k, _stream(p.device))
    _build.check(err, "tail_apply")
    tail_apply.launches += 1
    return z


def tail_max(p, bvec, mean, scale, beta, with_sum: bool = False):
    """``(max_k z, first argmax_k z, sum_k e or None)`` of ``z =
    lrelu((e - mean) * scale + beta)``: (B, N, C) each, the argmax as
    :func:`am_dtype` gives it."""
    _count_route(p)
    if p.device.type == "cpu":
        return tail_max_plain(p, bvec, mean, scale, beta, with_sum)
    p, bvec, mean, scale, beta = _prepared(p, bvec, vectors=(mean, scale, beta))
    b, n, k, c = p.shape
    mx = torch.empty((b, n, c), dtype=torch.float32, device=p.device)
    am = torch.empty((b, n, c), dtype=torch.int8, device=p.device)
    se = torch.empty_like(mx) if with_sum else None
    err = _build.lib().dgcnn_train_tail_max(
        p.data_ptr(), _ptr(bvec), mean.data_ptr(), scale.data_ptr(), beta.data_ptr(),
        mx.data_ptr(), am.data_ptr(), _ptr(se), b * n, k, _stream(p.device))
    _build.check(err, "tail_max")
    tail_max.launches += 1
    return mx, am, se


def tail_grad(p, bvec, g, mean, inv, gamma, beta, t1, t2, m: int):
    """``de = gamma * inv * (gp - (t1 + xhat * t2) / m)`` (B, N, k, C) and
    ``d_bvec = sum_k de`` (B, N, C) where ``bvec`` is given (else None);
    ``m`` the global batch's row count."""
    if p.device.type == "cpu":
        return tail_grad_plain(p, bvec, g, mean, inv, gamma, beta, t1, t2, m)
    gi = gamma * inv
    p, bvec, g, mean, inv, gamma, beta, gi, t1, t2 = _prepared(
        p, bvec, g, vectors=(mean, inv, gamma, beta, gi, t1, t2))
    b, n, k, c = p.shape
    de = torch.empty_like(p)
    d_bvec = None if bvec is None else torch.empty((b, n, c), dtype=torch.float32,
                                                   device=p.device)
    err = _build.lib().dgcnn_train_tail_grad(
        p.data_ptr(), _ptr(bvec), g.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), gi.data_ptr(), t1.data_ptr(), t2.data_ptr(),
        m, de.data_ptr(), _ptr(d_bvec), b * n, k, _stream(p.device))
    _build.check(err, "tail_grad")
    tail_grad.launches += 1
    return de, d_bvec


def tail_max_grad(e, am, gp, mean, inv, gamma, t1, t2, m: int) -> torch.Tensor:
    """The max tails' ``de`` (B, N, k, C): ``gamma * inv * (dy - (t1 + xhat
    * t2) / m)``, ``dy`` the (B, N, C) cotangent ``gp`` at slot ``am`` and
    0 elsewhere."""
    if e.device.type == "cpu":
        return tail_max_grad_plain(e, am, gp, mean, inv, gamma, t1, t2, m)
    gi = gamma * inv
    e, am, gp, mean, inv, gi, t1, t2 = _prepared(e, am.to(torch.int8), gp,
                                                 vectors=(mean, inv, gi, t1, t2))
    b, n, k, _ = e.shape
    de = torch.empty_like(e)
    err = _build.lib().dgcnn_train_tail_max_grad(
        e.data_ptr(), am.data_ptr(), gp.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        gi.data_ptr(), t1.data_ptr(), t2.data_ptr(), m, de.data_ptr(), b * n, k,
        _stream(e.device))
    _build.check(err, "tail_max_grad")
    tail_max_grad.launches += 1
    return de


for _fn in (tail_sums, tail_grad_sums, tail_apply, tail_max, tail_grad, tail_max_grad):
    _fn.launches = 0
