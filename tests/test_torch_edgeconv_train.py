"""The training tails' point-term fold and route counters on the CPU
(``ops/edgeconv.py::bn_lrelu_train(..., bvec)``,
``kernels/edgeconv_train.py``): the Function with the conv's point term
against autograd of the unfused chain ``lrelu(BN_train(p + bvec))``, the
add included, ``gradcheck`` in float64, and the recorder's
``edgeconv.train_tail.*`` counters over a training forward. The kernels
themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py -k train_tail``)."""

import pytest
import torch

from dgcnn_tpu_torch.kernels import edgeconv_train as et
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNConfig
from dgcnn_tpu_torch.ops import edgeconv as ec
from dgcnn_tpu_torch.utils import profiling
from torch_port_helpers import torch_threads


def _inputs(b, n, k, c, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    p = (torch.randn((b, n, k, c), generator=g) * 2 + 0.5).to(dtype)
    bvec = torch.randn((b, n, c), generator=g).to(dtype)
    gamma = ((torch.rand(c, generator=g) + 0.5)
             * torch.where(torch.rand(c, generator=g) < 0.3, -1.0, 1.0)).to(dtype)
    beta = (0.2 * torch.randn(c, generator=g)).to(dtype)
    gz = torch.randn((b, n, k, c), generator=g).to(dtype)
    return p, bvec, gamma, beta, gz


def _unfused(p, bvec, gamma, beta):
    """The one-pass training BN + LeakyReLU on ``p + bvec`` by autograd."""
    e = p + bvec[:, :, None, :]
    mean = e.mean(dim=(0, 1, 2))
    var = ((e * e).mean(dim=(0, 1, 2)) - mean * mean).clamp_min(0.0)
    return ec.lrelu((e - mean) * (torch.rsqrt(var + 1e-5) * gamma) + beta)


def _grads(fn, args, cot):
    args = [a.detach().clone().requires_grad_(True) for a in args]
    out = fn(*args)
    (out * cot).sum().backward()
    return out.detach(), [a.grad for a in args]


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 2e-5), (torch.float64, 1e-11)])
def test_point_term_fold_matches_autograd_of_the_unfused_chain(dtype, tol):
    p, bvec, gamma, beta, gz = _inputs(2, 40, 6, 8, dtype, seed=1)
    with torch_threads(1):
        got = _grads(lambda *a: ec.bn_lrelu_train(a[0], a[2], a[3], a[1])[0],
                     (p, bvec, gamma, beta), gz)
        want = _grads(_unfused, (p, bvec, gamma, beta), gz)
    torch.testing.assert_close(got[0], want[0], rtol=tol, atol=tol)
    for name, a, b in zip(("p", "bvec", "gamma", "beta"), got[1], want[1]):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= tol * scale, name


def test_point_term_fold_is_the_function_on_the_sum():
    """On the CPU the fold computes what the Function computes on ``p +
    bvec``, bit for bit: the same chain, ``d_bvec`` the sum over k that
    autograd takes for the broadcast add."""
    p, bvec, gamma, beta, gz = _inputs(2, 24, 5, 8, torch.float32, seed=2)
    with torch_threads(1):
        folded = _grads(lambda *a: ec.bn_lrelu_train(a[0], a[2], a[3], a[1])[0],
                        (p, bvec, gamma, beta), gz)
        summed = _grads(lambda p_, b_, g_, be: ec.bn_lrelu_train(
            p_ + b_[:, :, None, :], g_, be)[0], (p, bvec, gamma, beta), gz)
    assert torch.equal(folded[0], summed[0])
    for a, b in zip(folded[1], summed[1]):
        assert torch.equal(a, b)


def test_point_term_fold_passes_gradcheck_in_float64():
    p, bvec, gamma, beta, _ = _inputs(1, 10, 4, 3, torch.float64, seed=3)
    args = [t.requires_grad_(True) for t in (p, bvec, gamma, beta)]
    with torch_threads(1):
        assert torch.autograd.gradcheck(
            lambda p_, b_, g_, be: ec.bn_lrelu_train(p_, g_, be, b_)[0], args,
            eps=1e-6, atol=1e-5)


@pytest.mark.parametrize("fused, want", [(True, 5), (False, 0)])
def test_training_forward_counts_its_tails_route(fused, want):
    """Five tails a training forward (stages 1-2: two each, stage 3: one),
    each counted once on the route it took: the plain one on the CPU."""
    cfg = DGCNNConfig(k=6, emb_dims=32, knn_impl="xla", stage_tail_fused=fused)
    model = DGCNN(cfg).train()
    for prm in model.parameters():
        torch.nn.init.normal_(prm, std=0.3)
    x = torch.randn((2, 48, 4), generator=torch.Generator().manual_seed(4))
    profiling.reset()
    try:
        with torch_threads(1), profiling.recording():
            model(x).sum().backward()
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.reset()
    assert counters.get("edgeconv.train_tail.plain", 0) == want
    assert counters.get("edgeconv.train_tail.kernel", 0) == 0


def test_plain_versions_route_the_max_cotangent_to_the_first_slot():
    p, _, gamma, beta, _ = _inputs(2, 16, 5, 4, torch.float32, seed=5)
    p[:, :, 3] = p[:, :, 1]  # exact ties: slot 1 holds the first maximum
    mean, inv = p.mean(dim=(0, 1, 2)), torch.ones(4)
    mx, am, se = et.tail_max_plain(p, None, mean, inv * gamma, beta, with_sum=True)
    assert am.dtype == torch.int8 and not (am == 3).any()
    assert torch.equal(se, p.sum(dim=2))
    gp = torch.randn(mx.shape, generator=torch.Generator().manual_seed(6))
    zero = torch.zeros(4)
    de = et.tail_max_grad_plain(p, am, gp, mean, inv, gamma, zero, zero, 10)
    # with t1 = t2 = 0 only the argmax slot gets gamma * inv * gp
    want = et.route(am, gp, p.shape[2]) * gamma
    assert torch.equal(de, want)
