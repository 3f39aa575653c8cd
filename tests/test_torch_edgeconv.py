"""Port EdgeConv stages (dgcnn_tpu_torch) against the JAX package on the
CPU: the fused kernels' plain versions against the interpreted Pallas
kernels, and the unfused chain against ops/edgeconv.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.edgeconv_pallas import (
    edgeconv_fused_extrema as jax_extrema,
    edgeconv_fused_stage as jax_stage,
    fold_bn as jax_fold_bn,
)
from dgcnn_tpu.ops import edgeconv as jax_ec
from dgcnn_tpu_torch.kernels.edgeconv_fused import (
    edgeconv_fused_extrema,
    edgeconv_fused_stage,
    fold_bn,
)
from dgcnn_tpu_torch.ops import edgeconv as ec
from dgcnn_tpu_torch.ops.knn import knn
from torch_port_helpers import random_bn, sorted_blocks

B, N, K, C = 2, 300, 12, 64
# the 64-long dots are summed in different orders by the two frameworks;
# everything else is elementwise in the same order
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    pts = sorted_blocks(B, N, seed=0)
    idx = knn(torch.from_numpy(pts), K).numpy()  # real neighbour indices
    bns = {name: random_bn(rng, C) for name in ("a", "b", "e")}
    return {
        "x": pts,
        "idx": idx,
        "table": rng.standard_normal((B, N, C)).astype(np.float32),
        "bvec": rng.standard_normal((B, N, C)).astype(np.float32),
        "w2": rng.uniform(-0.125, 0.125, (C, C)).astype(np.float32),
        "bn": bns,
    }


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _bn_args(bn):
    return bn["gamma"], bn["beta"], bn["mean"], bn["var"]


def _fold_torch(bn):
    return fold_bn(*_t(*_bn_args(bn)))


def _fold_jax(bn):
    return [np.asarray(v) for v in jax_fold_bn(*map(jnp.asarray, _bn_args(bn)))]


def test_fold_bn_matches_jax(inputs):
    bn = inputs["bn"]["a"]
    got = _fold_torch(bn)
    want = _fold_jax(bn)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=1e-6)


# (n, k): the fixture's shape, the k the CUDA kernel pads to one (k <= 32)
# or two (k = 40) units of 32 rows, and a ragged N (the JAX kernel pads the
# rows to its 64-query tile)
STAGE_SHAPES = [(N, K), (N, 20), (N, 30), (N, 40), (301, 30)]


@pytest.mark.parametrize("n, k", STAGE_SHAPES)
def test_fused_stage_plain_matches_jax_kernel(inputs, n, k):
    a, b = inputs["bn"]["a"], inputs["bn"]["b"]
    sa, ta = _fold_jax(a)
    sb, tb = _fold_jax(b)
    if (n, k) == (N, K):
        table, idx, bvec = inputs["table"], inputs["idx"], inputs["bvec"]
    else:
        rng = np.random.default_rng(n * 100 + k)
        table, bvec = rng.standard_normal((2, B, n, C)).astype(np.float32)
        idx = knn(torch.from_numpy(sorted_blocks(B, n, seed=k)), k).numpy()
    args = (table, idx, bvec, inputs["w2"], sa, ta, sb, tb)
    got = edgeconv_fused_stage(*_t(*args)).numpy()
    want = np.asarray(jax_stage(*map(jnp.asarray, args), interpret=True))
    assert got.shape == (B, n, C)
    np.testing.assert_allclose(got, want, **TOL)


def test_fused_extrema_plain_matches_jax_kernel(inputs):
    e = inputs["bn"]["e"]
    s, t = _fold_jax(e)
    args = (inputs["table"], inputs["idx"], inputs["bvec"], e["gamma"], s, t)
    got = edgeconv_fused_extrema(*_t(*args)).numpy()
    want = np.asarray(jax_extrema(*map(jnp.asarray, args), interpret=True))
    assert (e["gamma"] < 0).any() and (e["gamma"] >= 0).any()
    np.testing.assert_allclose(got, want, **TOL)


def test_gather_neighbors_matches_jax(inputs):
    got = ec.gather_neighbors(*_t(inputs["table"], inputs["idx"])).numpy()
    want = np.asarray(jax_ec.gather_neighbors(jnp.asarray(inputs["table"]),
                                              jnp.asarray(inputs["idx"])))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gather_first", [None, True, False])
def test_edge_conv_linear_matches_jax(inputs, gather_first):
    rng = np.random.default_rng(1)
    x = inputs["x"]
    w = rng.uniform(-0.3, 0.3, (2 * x.shape[-1], C)).astype(np.float32)
    got = ec.edge_conv_linear(*_t(x, inputs["idx"], w),
                              gather_first=gather_first).numpy()
    want = np.asarray(jax_ec.edge_conv_linear(
        *map(jnp.asarray, (x, inputs["idx"], w)), gather_first=gather_first))
    assert got.shape == (B, N, K, C)
    np.testing.assert_allclose(got, want, **TOL)


def test_edge_conv_linear_extrema_matches_jax(inputs):
    rng = np.random.default_rng(2)
    feats = inputs["table"]
    w = rng.uniform(-0.125, 0.125, (2 * C, C)).astype(np.float32)
    got = ec.edge_conv_linear_extrema(*_t(feats, inputs["idx"], w))
    want = jax_ec.edge_conv_linear_extrema(*map(jnp.asarray, (feats, inputs["idx"], w)))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)


def test_fused_plain_versions_equal_unfused_chain(inputs):
    """The fused stages are an epilogue rewrite of the unfused chain: the
    plain versions must agree with gather -> BN -> LReLU -> conv -> max."""
    a, b = inputs["bn"]["a"], inputs["bn"]["b"]
    table, idx, bvec, w2 = _t(inputs["table"], inputs["idx"], inputs["bvec"], inputs["w2"])
    sa, ta = _fold_torch(a)
    sb, tb = _fold_torch(b)
    fused = edgeconv_fused_stage(table, idx, bvec, w2, sa, ta, sb, tb)
    e = ec.gather_neighbors(table, idx) + bvec[:, :, None, :]
    e = e * sa + ta
    e = torch.where(e >= 0, e, 0.2 * e) @ w2
    e = e * sb + tb
    chain = ec.max_over_k(torch.where(e >= 0, e, 0.2 * e))
    torch.testing.assert_close(fused, chain, **TOL)


def test_fused_stage_refuses_bf16(inputs):
    args = _t(inputs["table"], inputs["idx"], inputs["bvec"], inputs["w2"],
              *([np.ones(C, np.float32)] * 4))
    with pytest.raises(NotImplementedError):
        edgeconv_fused_stage(*args, bf16_mm=True)
