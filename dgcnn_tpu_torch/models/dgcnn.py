"""DGCNN (EdgeConv) semantic segmentation: config, init, forward.

Counterpart of ``dgcnn_tpu/models/dgcnn.py``. Layout is channels-last
(B, N, C) and every 1x1 conv is a (C_in, C_out) matmul, as in the JAX
package, so a JAX parameter tree maps onto this module's ``state_dict`` by
renaming (:func:`params_from_jax`). The trunk (conv6-conv9) is
``ops/matmul.py::mm`` in the config's product mode (FP32 by default; TF32,
bf16 or f16 operands with an FP32 result: ``DGCNNConfig``); the EdgeConv stages run the port's
kNN and fused stage kernels: on CUDA, by default, the banded stage-1 kNN (certified, with
exact repair) and the banded feature kNN of stages 2-3 (recall-guarded),
each falling back to the capped kNN on the device.

Channel plan: conv1 2F->64, conv2 64->64 | conv3 128->64, conv4 64->64 |
conv5 128->64 | conv6 192->emb | conv7 emb+192->512, conv8 512->256,
conv9 256->C. All convs bias-free; each but conv9 followed by BatchNorm
(eps 1e-5) and LeakyReLU(0.2).

Training mode (``model.train()``) runs batch-statistics BN (the running
statistics update in place once the forward is done, torch semantics:
momentum 0.1, unbiased running variance), the training stage tails of
``ops/edgeconv.py`` whose backward passes carry the scatter kernels, and
dropout drawn from an explicit ``torch.Generator``. The kNN always runs on
detached features. ``remat`` recomputes activations in the backward
(``torch.utils.checkpoint``, non-reentrant) at the JAX package's
``checkpoint_name(_, "pt")`` sites: ``"selective"`` keeps the kNN indices
and the stage outputs and recomputes each stage's (B, N, k, C) chain and
the trunk, each region just before its backward; ``"full"`` keeps nothing
of the forward: one region around it all, so the kNN runs again, with the
selective regions nested inside it, so that its recompute holds one
stage's chain at a time (a single region would hold the whole forward's
activations again at the backward's start: no lower peak than "off"). No
region that is recomputed updates a running statistic or draws from a
generator: the statistics come out of the regions as values (as JAX
returns them) and the dropout mask is drawn before the first region.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from dgcnn_tpu_torch.kernels.edgeconv_fused import (
    edgeconv_fused_extrema,
    edgeconv_fused_stage,
    fold_bn,
)
from dgcnn_tpu_torch.kernels.knn_approx import knn_approx
from dgcnn_tpu_torch.kernels.knn_banded import knn_banded, knn_feature_banded
from dgcnn_tpu_torch.kernels.knn_capped import knn_capped
from dgcnn_tpu_torch.kernels.knn_exact_banded import knn_exact_banded
from dgcnn_tpu_torch.kernels.knn_packed import knn_packed
from dgcnn_tpu_torch.ops.edgeconv import (
    bn_lrelu_max_train,
    bn_lrelu_train,
    edge_conv_linear,
    edge_conv_linear_extrema,
    edge_conv_terms,
    edge_stage_tail_train,
    lrelu,
    max_over_k,
)
from dgcnn_tpu_torch.ops.knn import knn
from dgcnn_tpu_torch.ops.matmul import mm
from dgcnn_tpu_torch.parallel.collectives import (
    batch_count,
    batch_group,
    batch_reduce,
    draw_local,
)

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1
# the approximate kNN's recall target: JAX's knn(approx=True) default, which
# its model passes on (dgcnn_tpu/models/dgcnn.py's "approx" branch)
APPROX_RECALL = 0.95


@dataclasses.dataclass(frozen=True)
class DGCNNConfig:
    """Static model configuration. Field names, values and defaults come
    from ``dgcnn_tpu.models.dgcnn.DGCNNConfig`` (so configs and CLI flags
    carry across), except ``knn_impl``, whose default is the CLI's
    ``"auto"``. TPU-only fields are left out: ``knn_train_unroll``
    (Mosaic compile time) and ``dropout_rng_impl`` (the TPU hardware RNG).

    ``ring_band_shards`` / ``ring_band_feature_shards``: the banded ring
    kNN of the point-sharded path (``parallel/ring_knn.py``): stage 1 visits
    only the 2s+1 ring-adjacent shards, certified, falling back to the full
    ring (default 1); stages 2-3 likewise without a certificate, where the
    coordinates are x-sorted (default 0: the full ring).

    ``knn_impl``: "auto" (the default), "pallas_capped" (with the bands),
    "xla" (the exact kNN in plain PyTorch), "pallas" (the parity mode: the
    exact banded kNN, bit for bit the exact kNN's indices, stage 1 banded
    at ``knn_band`` and stages 2-3 at full width, with the JAX wrapper's
    own 64 windows, cap 8 and repair budget 256), "pallas_packed" (the
    flat packed kNN on every stage) and "approx" (JAX's ``approx_max_k`` at
    its recall target 0.95 on every stage: ``ops/knn.py::knn(...,
    approx=True)`` on the CPU, the approximate kNN kernel,
    ``kernels/knn_approx.py``, on CUDA; each query's scores folded into
    ``approx_reduction_size(N, k, 0.95)`` bins by row mod L, a fold chosen by
    the port where the TPU's cannot be observed, the exact kNN where L = N).

    ``compute_dtype`` and ``matmul_precision``: the JAX package's two
    knobs of its conv products (everything JAX routes through ``_mm``: the
    stages' point terms, stages 1-2's second conv, conv6-conv9), mapped to
    one product mode (:attr:`product_mode`, ``ops/matmul.py``) on every
    device of the port:

    ==============  =================  ===========================  ==============
    compute_dtype   matmul_precision   operands of each product     fused stages
                                                                    ("auto", CUDA)
    ==============  =================  ===========================  ==============
    None            None               FP32                         FP32 kernel
    None            "default"          TF32 (round_tf32)            TF32 kernel
    "float32"       "default"          TF32                         unfused
    None            "high"             FP32                         FP32 kernel
    any             "highest"          FP32, or the 16-bit dtype    unfused
    "bfloat16"      not "highest"      bf16                         bf16 kernel
    "float16"       any                f16                          unfused
    "float32"       None or "high"     FP32                         unfused
    ==============  =================  ===========================  ==============

    Every result is FP32 and never rounded to the operands' type; the kNN
    scores, BN, LeakyReLU, the maxima, the softmax, the loss and the
    optimizer stay FP32 in every mode (TF32 never reaches a kNN score: it
    is allowed only inside the product call, ``ops/matmul.py::
    tf32_enabled``). The fused stages follow JAX's ``_fuse_on``
    (:func:`fuse_on`); under ``fuse_epilogue=True`` the stage kernel is the
    bf16 one for "bfloat16", else the TF32 one under "default" and the FP32
    one otherwise (JAX's ``bf16_mm=False`` for f16: FP32 operands at the set
    precision). Divergences from JAX, by design: None is FP32 here (JAX's
    is the backend's default); "default" is TF32 on every device (JAX's is
    backend-dependent: bf16 passes on a TPU, FP32 on its CPU); "high" is
    FP32 (a TF32 operand is below what HIGH promises, bf16_3x's ~16 bits);
    and ``compute_dtype`` takes only None, "bfloat16", "float16" and
    "float32", any other raising ``ValueError`` (JAX would fail later or
    cast silently). bf16 and f16 train with JAX's backward of the mode
    (operand cotangents rounded to the dtype), TF32 with JAX's (each
    backward product's operands rounded to TF32, FP32 results;
    ``ops/matmul.py``); the gathers and scatters stay FP32. f16 mirrors JAX:
    an operand above 65504 becomes inf, with no loss scaling and no clamp.
    A 16-bit mode's outputs leave the FP32 reference-parity class (they
    match the JAX package's forward of the same mode).

    ``bn_stats`` and ``stage_tail_fused``
    configure training: the fused tails run with ``stage_tail_fused`` and
    one-pass statistics, the unfused chain (autograd through plain BN)
    otherwise."""

    num_classes: int = 5
    num_features: int = 4
    k: int = 30
    dropout: float = 0.5
    emb_dims: int = 1024
    knn_query_chunk: int | None = 1024
    compute_dtype: str | None = None
    # "xla"|"approx"|"pallas"|"pallas_packed"|"pallas_capped"|"auto"
    knn_impl: str = "auto"
    knn_cap: int = 8
    knn_band_cap: int = 6
    knn_band_nwin: int = 64
    knn_band: int = 2048
    knn_band_feature: int = 4096
    knn_band_recall_guard: int = 256
    knn_band_recall_threshold: float = 0.995
    knn_band_guard_every: int = 8
    knn_share_stage3: bool = False
    # True / "auto": the fused stage kernels on CUDA ("auto" keeps the
    # unfused chain on the CPU, as the JAX package does off-TPU)
    fuse_epilogue: "bool | str" = "auto"
    bn_stats: str = "one_pass"
    stage_tail_fused: bool = True
    matmul_precision: str | None = None
    ring_band_shards: int = 1
    ring_band_feature_shards: int = 0

    _KNN_IMPLS = ("xla", "approx", "pallas", "pallas_packed",
                  "pallas_capped", "auto")
    _BN_STATS = ("one_pass", "two_pass")
    _PRECISIONS = (None, "default", "high", "highest")
    _COMPUTE_DTYPES = (None, "bfloat16", "float16", "float32")

    def __post_init__(self):
        if self.knn_impl not in self._KNN_IMPLS:
            raise ValueError(f"knn_impl {self.knn_impl!r} not in {self._KNN_IMPLS}")
        if self.bn_stats not in self._BN_STATS:
            raise ValueError(f"bn_stats {self.bn_stats!r} not in {self._BN_STATS}")
        if self.fuse_epilogue not in (True, False, "auto"):
            raise ValueError(
                f"fuse_epilogue {self.fuse_epilogue!r} must be True, False or 'auto'")
        for f_ in ("knn_band", "knn_band_feature"):
            v = getattr(self, f_)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0 or v % 256:
                raise ValueError(f"{f_} {v!r} must be a non-negative multiple of 256")
        if (self.knn_band or self.knn_band_feature) and (
                self.knn_band_cap * self.knn_band_nwin < self.k):
            raise ValueError(
                f"banded extraction capacity knn_band_cap*knn_band_nwin="
                f"{self.knn_band_cap * self.knn_band_nwin} < k={self.k}")
        if (not isinstance(self.knn_band_recall_guard, int)
                or isinstance(self.knn_band_recall_guard, bool)
                or self.knn_band_recall_guard < 0):
            raise ValueError(
                f"knn_band_recall_guard {self.knn_band_recall_guard!r} must be "
                "a non-negative int")
        if not 0.0 <= float(self.knn_band_recall_threshold) <= 1.0:
            raise ValueError(
                f"knn_band_recall_threshold {self.knn_band_recall_threshold!r} "
                "must be in [0, 1]")
        if (not isinstance(self.knn_band_guard_every, int)
                or isinstance(self.knn_band_guard_every, bool)
                or self.knn_band_guard_every < 1):
            raise ValueError(
                f"knn_band_guard_every {self.knn_band_guard_every!r} must be a "
                "positive int")
        for f_ in ("ring_band_shards", "ring_band_feature_shards"):
            v = getattr(self, f_)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(f"{f_} {v!r} must be a non-negative int")
        if not isinstance(self.knn_share_stage3, bool):
            raise ValueError(
                f"knn_share_stage3 {self.knn_share_stage3!r} must be a bool")
        if self.matmul_precision not in self._PRECISIONS:
            raise ValueError(
                f"matmul_precision {self.matmul_precision!r} not in {self._PRECISIONS}")
        if self.compute_dtype not in self._COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r} not in {self._COMPUTE_DTYPES}")

    @property
    def product_mode(self):
        """The conv products' mode (``ops/matmul.py``): ``torch.bfloat16``
        or ``torch.float16`` for those dtypes, else ``"tf32"`` under
        ``matmul_precision="default"`` and None (FP32) otherwise."""
        if self.compute_dtype in ("bfloat16", "float16"):
            return getattr(torch, self.compute_dtype)
        return "tf32" if self.matmul_precision == "default" else None

    @property
    def stage_product(self):
        """The fused stage kernel's second-conv mode: ``torch.bfloat16`` (the
        bf16 kernel) for ``compute_dtype="bfloat16"``, else ``"tf32"`` (the
        TF32 kernel) under ``matmul_precision="default"``, else None (the
        FP32 kernel)."""
        if self.compute_dtype == "bfloat16":
            return torch.bfloat16
        return "tf32" if self.matmul_precision == "default" else None


def resolve_knn_impl(cfg: DGCNNConfig, device: torch.device) -> str:
    """The kNN the forward runs on ``device``: "auto" is the capped kernel
    (banded where ``knn_band`` / ``knn_band_feature`` say so) on CUDA and
    the exact kNN on the CPU (the JAX package's off-TPU choice); every other
    value runs as it is named."""
    impl = cfg.knn_impl
    if impl == "auto":
        impl = "pallas_capped" if torch.device(device).type == "cuda" else "xla"
    return impl


def fuse_on(cfg: DGCNNConfig, device: torch.device) -> bool:
    """Resolved ``fuse_epilogue``, JAX's ``_fuse_on`` with CUDA in the TPU's
    place: True always fuses; "auto" fuses on CUDA where ``compute_dtype``
    is None or "bfloat16" and ``matmul_precision`` is not "highest" (the
    unfused parity mode). (The TPU's VMEM table gate does not apply: the
    CUDA kernels read the table from device memory.)"""
    if cfg.fuse_epilogue is True:
        return True
    return (cfg.fuse_epilogue == "auto" and torch.device(device).type == "cuda"
            and cfg.compute_dtype in (None, "bfloat16")
            and cfg.matmul_precision != "highest")


def _plan(cfg: DGCNNConfig) -> dict[str, tuple[int, int]]:
    f, emb = cfg.num_features, cfg.emb_dims
    return {
        "conv1": (2 * f, 64), "conv2": (64, 64), "conv3": (128, 64),
        "conv4": (64, 64), "conv5": (128, 64), "conv6": (192, emb),
        "conv7": (emb + 192, 512), "conv8": (512, 256),
        "conv9": (256, cfg.num_classes),
    }


class _Conv(nn.Module):
    """Bias-free pointwise conv, weight stored channels-last (C_in, C_out)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(c_in, c_out))


class _BatchNorm(nn.Module):
    """BatchNorm over the last axis: ``(x - mean) * (rsqrt(var + eps) *
    gamma) + beta``, in the JAX package's operation order, with the running
    statistics in eval mode (:meth:`forward`) or the batch's
    (:meth:`train_forward`)."""

    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.var + _BN_EPS)
        return (x - self.mean) * (inv * self.gamma) + self.beta

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        return fold_bn(self.gamma, self.beta, self.mean, self.var)

    def batch_forward(self, x: torch.Tensor, one_pass: bool = True):
        """Training BN: normalise with the batch mean and biased variance
        (``E[x^2] - E[x]^2`` with ``one_pass``, else the two-pass form).
        Returns ``(y, mean, var)``; the caller updates the running
        statistics (:meth:`update_running`)."""
        return batch_norm_train(x, self.gamma, self.beta, one_pass)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor, count: int) -> None:
        """``running = (1 - m) * running + m * batch`` in place (m = 0.1),
        with the UNBIASED batch variance for the running variance."""
        unbiased = var * (count / max(count - 1, 1))
        self.mean.copy_((1 - _BN_MOMENTUM) * self.mean + _BN_MOMENTUM * mean)
        self.var.copy_((1 - _BN_MOMENTUM) * self.var + _BN_MOMENTUM * unbiased)


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     one_pass: bool = True):
    """``(y, mean, biased var)`` of training BN over all leading axes. Under
    data parallelism (``parallel/collectives.py::batch_parallel``) the sums
    are taken over the global batch, across the ranks; without it, the
    single-card reduction as it always was."""
    axes = tuple(range(x.ndim - 1))
    if batch_group() is None:
        mean = x.mean(dim=axes)
        if one_pass:
            var = ((x * x).mean(dim=axes) - mean * mean).clamp_min(0.0)
        else:
            var = ((x - mean) ** 2).mean(dim=axes)
    else:
        count = batch_count(x.numel() // x.shape[-1])
        if one_pass:
            sums = batch_reduce(torch.stack([x.sum(dim=axes), (x * x).sum(dim=axes)]))
            mean = sums[0] / count
            var = (sums[1] / count - mean * mean).clamp_min(0.0)
        else:
            mean = batch_reduce(x.sum(dim=axes)) / count
            var = batch_reduce(((x - mean) ** 2).sum(dim=axes)) / count
    inv = torch.rsqrt(var + _BN_EPS)
    return (x - mean) * (inv * gamma) + beta, mean.detach(), var.detach()


def remat_mode(remat: "bool | str") -> str:
    """JAX's ``remat`` values as "off", "selective" or "full": False or
    "off", "selective", True or "full"; anything else raises
    ``ValueError`` naming ``remat``."""
    if remat is False or remat == "off":
        return "off"
    if remat is True or remat == "full":
        return "full"
    if remat == "selective":
        return "selective"
    raise ValueError(f"remat must be bool, 'off', 'selective' or 'full'; got {remat!r}")


def _recomputed(fn, *args):
    """``fn(*args)`` as a region whose activations the backward recomputes
    (non-reentrant: the custom Functions' saved tensors go through its
    hooks). No global RNG state is saved: nothing in a region draws."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def _kept(fn, *args):
    return fn(*args)


class DGCNN(nn.Module):
    """The DGCNN segmentation model. Constructed in eval mode; ``.train()``
    switches to batch-statistics BN and dropout. ``state_dict`` keys are
    ``convN.w`` and ``bnN.{gamma,beta,mean,var}``, the JAX leaf names with
    ``/`` as ``.``."""

    def __init__(self, cfg: DGCNNConfig):
        super().__init__()
        self.cfg = cfg
        for name, (ci, co) in _plan(cfg).items():
            setattr(self, name, _Conv(ci, co))
            if name != "conv9":
                setattr(self, name.replace("conv", "bn"), _BatchNorm(co))
        # the tensor-parallel trunk's mesh (parallel/tensor_parallel.py::
        # shard_params_tp); None: the replicated trunk
        self.tp_mesh = None
        self.eval()

    def _knn(self, x: torch.Tensor, impl: str, *, spatial: bool = False,
             sorted_ok: torch.Tensor | None = None,
             guard_ok: bool | None = None, with_flag: bool = False):
        """The stage's neighbour indices (B, N, k), as the JAX ``_knn``:
        ``spatial`` (stage 1, coordinates) takes the certified banded kNN
        when ``knn_band``; the feature stages take the recall-guarded
        banded kNN when ``knn_band_feature`` and ``sorted_ok`` (whether the
        POINTS are x-sorted) is given. ``with_flag`` returns ``(idx,
        tripped)``; only the feature-banded kNN can trip."""
        cfg = self.cfg
        if impl == "pallas_capped" and not spatial and cfg.knn_band_feature \
                and sorted_ok is not None:
            return knn_feature_banded(
                x, cfg.k, sorted_ok=sorted_ok, band=cfg.knn_band_feature,
                cap=cfg.knn_band_cap, n_win=cfg.knn_band_nwin,
                capped_cap=cfg.knn_cap,
                recall_guard=cfg.knn_band_recall_guard,
                recall_threshold=cfg.knn_band_recall_threshold,
                guard_ok=guard_ok, with_flag=with_flag)
        if impl == "pallas_capped" and spatial and cfg.knn_band:
            idx = knn_banded(x, cfg.k, band=cfg.knn_band, cap=cfg.knn_band_cap,
                             n_win=cfg.knn_band_nwin, capped_cap=cfg.knn_cap)
        elif impl == "pallas":
            # the parity mode: the wrapper's own windows, cap and budget,
            # as the JAX forward; the feature stages scan the full width
            idx = knn_exact_banded(x, cfg.k, band=cfg.knn_band if spatial else 0)
        elif impl == "pallas_packed":
            idx = knn_packed(x, cfg.k)
        elif impl == "pallas_capped":
            idx = knn_capped(x, cfg.k, cap=cfg.knn_cap)
        elif impl == "approx" and x.device.type == "cuda":
            idx = knn_approx(x, cfg.k, APPROX_RECALL)
        elif impl == "approx":
            idx = knn(x, cfg.k, query_chunk=cfg.knn_query_chunk, approx=True,
                      recall_target=APPROX_RECALL)
        else:
            idx = knn(x, cfg.k, query_chunk=cfg.knn_query_chunk)
        if with_flag:
            return idx, torch.zeros((), dtype=torch.bool, device=x.device)
        return idx

    def _two_conv(self, x, idx, n: int, fused: bool):
        """Stage 1 (n = 1) or 2 (n = 3): ``(out, updates)``, ``updates``
        the running-statistics updates ``(bn, mean, var, count)`` it owes
        (none in eval mode)."""
        conv_a, bn_a = getattr(self, f"conv{n}"), getattr(self, f"bn{n}")
        conv_b, bn_b = getattr(self, f"conv{n + 1}"), getattr(self, f"bn{n + 1}")
        cd = self.cfg.product_mode
        if self.training:
            count = batch_count(x.shape[0] * x.shape[1] * idx.shape[-1])
            if self._fused_tails():
                # the conv's point term goes into the tail, not into e
                p, bvec = edge_conv_terms(x, idx, conv_a.w, compute_dtype=cd)
                e, mean_a, var_a = bn_lrelu_train(p, bn_a.gamma, bn_a.beta, bvec)
                mx, mean_b, var_b = bn_lrelu_max_train(mm(e, conv_b.w, cd),
                                                       bn_b.gamma, bn_b.beta)
            else:
                one_pass = self.cfg.bn_stats == "one_pass"
                e = edge_conv_linear(x, idx, conv_a.w, compute_dtype=cd)
                y, mean_a, var_a = bn_a.batch_forward(e, one_pass)
                y, mean_b, var_b = bn_b.batch_forward(mm(lrelu(y), conv_b.w, cd), one_pass)
                mx = max_over_k(lrelu(y))
            return mx, [(bn_a, mean_a, var_a, count), (bn_b, mean_b, var_b, count)]
        if fused:
            c = x.shape[-1]
            w_d, w_x = conv_a.w[:c], conv_a.w[c:]
            sa, ta = bn_a.folded()
            sb, tb = bn_b.folded()
            stage = self.cfg.stage_product
            return edgeconv_fused_stage(
                mm(x, w_d, cd), idx, mm(x, w_x - w_d, cd), conv_b.w, sa, ta, sb, tb,
                bf16_mm=stage is torch.bfloat16, tf32_mm=stage == "tf32"), []
        e = lrelu(bn_a(edge_conv_linear(x, idx, conv_a.w, compute_dtype=cd)))
        return max_over_k(lrelu(bn_b(mm(e, conv_b.w, cd)))), []

    def _fused_tails(self) -> bool:
        return self.cfg.stage_tail_fused and self.cfg.bn_stats == "one_pass"

    def _single_conv(self, x, idx, fused: bool):
        """Stage 3: ``(out, updates)`` as :meth:`_two_conv`."""
        w, bn = self.conv5.w, self.bn5
        cd = self.cfg.product_mode
        if self.training:
            count = batch_count(x.shape[0] * x.shape[1] * idx.shape[-1])
            if self._fused_tails():
                c = x.shape[-1]
                w_d, w_x = w[:c], w[c:]
                mx, mean, var = edge_stage_tail_train(
                    mm(x, w_d, cd), mm(x, w_x - w_d, cd), idx, bn.gamma, bn.beta)
                return mx, [(bn, mean, var, count)]
            y, mean, var = bn.batch_forward(edge_conv_linear(x, idx, w, compute_dtype=cd),
                                            self.cfg.bn_stats == "one_pass")
            return max_over_k(lrelu(y)), [(bn, mean, var, count)]
        if fused:
            c = x.shape[-1]
            w_d, w_x = w[:c], w[c:]
            s5, t5 = bn.folded()
            return edgeconv_fused_extrema(
                mm(x, w_d, cd), idx, mm(x, w_x - w_d, cd), bn.gamma, s5, t5), []
        mx, mn = edge_conv_linear_extrema(x, idx, w, compute_dtype=cd)
        return lrelu(bn(torch.where(bn.gamma >= 0, mx, mn))), []

    def _bn(self, bn: _BatchNorm, x: torch.Tensor, updates: list) -> torch.Tensor:
        if not self.training:
            return bn(x)
        y, mean, var = bn.batch_forward(x, self.cfg.bn_stats == "one_pass")
        updates.append((bn, mean, var, batch_count(x.numel() // x.shape[-1])))
        return y

    def _trunk(self, x1, x2, x3, keep, depth: int, with_logits: bool):
        """conv6-conv9 on the stage outputs: ``(out, updates)``, ``out``
        the tap at ``depth`` (4-9), the logits, or with ``with_logits``
        ``(logits, tap)`` (the logits again for a tap below 4). ``keep``:
        the dropout mask (None: no dropout)."""
        cd = self.cfg.product_mode
        updates: list = []
        tap = []

        def done(d: int, v: torch.Tensor) -> bool:
            if d == depth:
                tap.append(v)
            return d == depth and not with_logits

        locals_ = torch.cat([x1, x2, x3], dim=-1)
        if done(4, locals_):
            return locals_, updates
        if self.tp_mesh is None:
            emb = lrelu(self._bn(self.bn6, mm(locals_, self.conv6.w, cd), updates))
        else:  # this rank's emb channels (parallel/tensor_parallel.py)
            from dgcnn_tpu_torch.parallel.tensor_parallel import bn6_slice, tp_conv6

            emb = lrelu(self._bn(bn6_slice(self), tp_conv6(self, locals_, cd), updates))
        if done(5, emb):
            return emb, updates
        global_ = emb.amax(dim=1)
        if done(6, global_):
            return global_, updates
        g = global_[:, None, :].expand(-1, x1.shape[1], -1)
        if self.tp_mesh is None:
            h = torch.cat([g, x1, x2, x3], dim=-1)
            if done(7, h):
                return h, updates
            h = mm(h, self.conv7.w, cd)
        else:
            from dgcnn_tpu_torch.parallel.tensor_parallel import tp_conv7

            if done(7, torch.cat([g, x1, x2, x3], dim=-1)):
                return tap[0], updates
            h = tp_conv7(self, g, locals_, cd)
        h = lrelu(self._bn(self.bn7, h, updates))
        if done(8, h):
            return h, updates
        h = lrelu(self._bn(self.bn8, mm(h, self.conv8.w, cd), updates))
        if done(9, h):
            return h, updates
        if keep is not None:
            h = _dropped(h, keep, self.cfg.dropout)
        logits = mm(h, self.conv9.w, cd)
        if with_logits:
            return (logits, tap[0] if tap else logits), updates
        return logits, updates

    def forward(self, x: torch.Tensor, depth: int = 10,
                with_logits: bool = False, band_mode: int | None = None,
                with_band_flag: bool = False,
                generator: torch.Generator | None = None,
                remat: "bool | str" = "off"):
        """x: (B, N, F) channels-last points. ``depth`` taps the forward
        as the JAX ``apply_dgcnn`` does: 1-3 -> x1..x3 (B,N,64), 4 ->
        concat (B,N,192), 5 -> conv6 out, 6 -> global max (B,emb), 7 ->
        global+locals, 8 -> conv7 out, 9 -> conv8 out, 10 -> logits
        (B,N,num_classes). ``with_logits`` with depth < 10 returns
        ``(logits, tap)`` from one full pass.

        ``band_mode`` (a host int; the amortized recall guard, see
        ``train/steps.py::BandGuardScheduler``): None guards every
        feature-banded kNN; 0 skips the guard's probes; 1 runs them; 2
        takes the capped kNN for the feature stages. ``with_band_flag``
        returns ``(logits, band_tripped)``, a 0-d bool tensor, True iff a
        guarded feature-banded kNN measured recall below the threshold and
        fell back; it requires depth 10 without ``with_logits``.

        In training mode ``generator`` (on x's device; default: torch's
        global one) draws the dropout mask, before anything else runs, and
        ``remat`` ("off", "selective" or "full", or JAX's False / True; see
        the module docstring) recomputes activations in the backward; the
        running statistics update once, after the forward."""
        cfg = self.cfg
        if x.ndim != 3 or x.shape[-1] != cfg.num_features:
            raise ValueError(f"expected (B, N, {cfg.num_features}) input, got {tuple(x.shape)}")
        if not 1 <= depth <= 10:
            raise ValueError(f"depth must be in 1..10, got {depth}")
        if with_band_flag and (depth != 10 or with_logits):
            raise ValueError(
                "with_band_flag requires depth=10 and with_logits=False")
        if band_mode not in (None, 0, 1, 2):
            raise ValueError(f"band_mode must be None, 0, 1 or 2, not {band_mode!r}")
        mode = remat_mode(remat) if self.training else "off"
        keep = None
        if self.training and cfg.dropout > 0 and (depth == 10 or with_logits):
            keep = dropout_mask((x.shape[0], x.shape[1], self.conv8.w.shape[1]),
                                cfg.dropout, generator, x.device)
        args = (x, keep, depth, with_logits, band_mode, with_band_flag)
        region = _kept if mode == "off" else _recomputed
        if mode == "full":
            out, updates = _recomputed(self._body, *args, region)
        else:
            out, updates = self._body(*args, region)
        for bn, mean, var, count in updates:
            bn.update_running(mean, var, count)
        return out

    def _body(self, x, keep, depth, with_logits, band_mode, with_band_flag, region):
        """The forward: ``(out, updates)``. ``region`` runs each stage and
        the trunk (:func:`_recomputed` for the selective remat: the kNN
        indices and the stage outputs are what the backward keeps)."""
        cfg = self.cfg
        impl = resolve_knn_impl(cfg, x.device)
        fused = fuse_on(cfg, x.device) and not self.training
        x = x.to(self.conv1.w.dtype)

        # sortedness of the POINTS' x column, computed once: the feature
        # tables cannot reveal it. Mode 2 (the host's sticky fallback)
        # rides the unsorted fallback: the capped kNN on the device.
        sorted_ok = guard_ok = None
        if cfg.knn_band_feature and impl == "pallas_capped":
            x0 = x[..., 0]
            sorted_ok = (x0[:, 1:] >= x0[:, :-1]).all()
            if band_mode is not None:
                if band_mode == 2:
                    sorted_ok = torch.zeros_like(sorted_ok)
                guard_ok = band_mode == 1
        flags = []  # the feature stages' trip flags (stage 1 cannot trip)

        def knn_(v, spatial=False):
            flag = with_band_flag and not spatial
            res = self._knn(v.detach(), impl, spatial=spatial, sorted_ok=sorted_ok,
                            guard_ok=guard_ok, with_flag=flag)
            if flag:
                flags.append(res[1])
                return res[0]
            return res

        x1, updates = region(self._two_conv, x, knn_(x, spatial=True), 1, fused)
        if depth == 1 and not with_logits:
            return x1, updates
        idx2 = knn_(x1)
        x2, upd = region(self._two_conv, x1, idx2, 3, fused)
        updates = updates + upd
        if depth == 2 and not with_logits:
            return x2, updates
        idx3 = idx2 if cfg.knn_share_stage3 else knn_(x2)
        x3, upd = region(self._single_conv, x2, idx3, fused)
        updates = updates + upd
        if depth == 3 and not with_logits:
            return x3, updates
        out, upd = region(self._trunk, x1, x2, x3, keep, depth, with_logits)
        updates = updates + upd
        if with_logits and depth <= 3:
            out = (out[0], (x1, x2, x3)[depth - 1])
        if with_band_flag:  # stages 2-3, or 2 alone when 3 shares its graph
            return (out, torch.stack(flags).any()), updates
        return out, updates


def dropout_mask(shape, p: float, generator: torch.Generator | None,
                 device) -> torch.Tensor:
    """Inverted dropout's keep mask: ``uniform < 1 - p`` (the JAX
    ``bernoulli``), the uniforms from ``generator`` on ``device``. JAX's
    random stream (and its one-bit-per-element draw at p = 0.5, a TPU RNG
    saving) cannot be reproduced, so the masks differ from JAX's."""
    u = draw_local(shape, lambda sh: torch.rand(sh, generator=generator, device=device))
    return u < 1.0 - p


def _dropped(h: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    return torch.where(keep, h / (1.0 - p), 0.0)


def dropout(h: torch.Tensor, p: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout: keep each element with probability ``1 - p``
    (:func:`dropout_mask`) and scale kept ones by ``1 / (1 - p)``."""
    return _dropped(h, dropout_mask(h.shape, p, generator, h.device), p)


def count_parameters(model: DGCNN) -> tuple[int, str]:
    """Total trainable parameter count and a per-module table, rows in the
    JAX parameter tree's order (``bn1/beta`` ... ``conv9/w``)."""
    rows = sorted((name.replace(".", "/"), p.numel())
                  for name, p in model.named_parameters())
    total = sum(n for _, n in rows)
    width = max(len(r[0]) for r in rows)
    lines = [f"{'Module':<{width}}  Parameters"]
    lines += [f"{name:<{width}}  {n}" for name, n in rows]
    lines.append(f"Total Trainable Params: {total}")
    return total, "\n".join(lines)


def init_dgcnn(cfg: DGCNNConfig, generator: torch.Generator | None = None,
               device: torch.device | str = "cpu") -> DGCNN:
    """A model with torch's default conv init on a 1x1 kernel,
    U(-1/sqrt(C_in), 1/sqrt(C_in)), drawn from ``generator``, and identity
    BatchNorm statistics; in eval mode on ``device``."""
    model = DGCNN(cfg)
    with torch.no_grad():
        for name, (ci, _) in _plan(cfg).items():
            w = getattr(model, name).w
            bound = 1.0 / math.sqrt(ci)
            w.copy_(torch.rand(w.shape, generator=generator) * (2 * bound) - bound)
    return model.to(device)


def params_from_jax(params: dict, bn_state: dict) -> dict[str, torch.Tensor]:
    """The JAX ``(params, bn_state)`` trees (nested dicts of arrays, as
    ``init_dgcnn`` / ``save_checkpoint`` hold them) as this module's
    ``state_dict``: ``params[convN]["w"]`` -> ``convN.w``,
    ``params[bnN][gamma|beta]`` -> ``bnN.gamma|beta``,
    ``bn_state[bnN][mean|var]`` -> ``bnN.mean|var``."""
    return {f"{name}.{leaf}": torch.from_numpy(np.array(v, np.float32))
            for tree in (params, bn_state)
            for name, leaves in tree.items() for leaf, v in leaves.items()}


def params_to_jax(state_dict: dict) -> tuple[dict, dict]:
    """Inverse of :func:`params_from_jax`: numpy ``(params, bn_state)``."""
    params: dict = {}
    bn_state: dict = {}
    for key, v in state_dict.items():
        name, leaf = key.split(".")
        tree = bn_state if leaf in ("mean", "var") else params
        tree.setdefault(name, {})[leaf] = v.detach().cpu().numpy()
    return params, bn_state
