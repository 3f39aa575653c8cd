"""The port imports nothing of the JAX package: an AST walk over every
source of the port, and its host modules (copies of the JAX package's)
against their originals on the same inputs — byte-equal or identical
results."""

import ast
import dataclasses
import json
import os
import pathlib

import numpy as np
import pytest

import dgcnn_tpu.io.las as jax_las
import dgcnn_tpu.prepare.blocks as jax_blocks
import dgcnn_tpu.prepare.dtm as jax_dtm
import dgcnn_tpu.prepare.loaders as jax_loaders
import dgcnn_tpu.prepare.tile_load as jax_tile_load
import dgcnn_tpu.serve.service as jax_service
import dgcnn_tpu_torch.io.las as las
import dgcnn_tpu_torch.prepare.blocks as blocks
import dgcnn_tpu_torch.prepare.dtm as dtm
import dgcnn_tpu_torch.prepare.loaders as loaders
import dgcnn_tpu_torch.prepare.tile_load as tile_load
import dgcnn_tpu_torch.serve.service as service
from dgcnn_tpu.train.checkpoint import save_checkpoint
from dgcnn_tpu.models.dgcnn import DGCNNConfig as JaxConfig
from dgcnn_tpu_torch.utils.logging import IOStream
from torch_port_helpers import jax_weights, write_scene

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted(str(p.relative_to(REPO)) for p in (REPO / "dgcnn_tpu_torch").rglob("*.py"))
SOURCES = PORT_SOURCES + ["chip_smoke.py"] + sorted(
    str(p.relative_to(REPO)) for p in (REPO / "scripts").glob("torch_*.py"))


def _forbidden(module: str) -> bool:
    return module in ("jax", "dgcnn_tpu") or module.startswith(("jax.", "dgcnn_tpu."))


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_neither_jax_nor_the_jax_package(path):
    """Every import statement, at any depth (inside functions too)."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_the_walk_sees_the_whole_port():
    assert len(PORT_SOURCES) >= 30
    assert "dgcnn_tpu_torch/train/loop.py" in PORT_SOURCES
    assert _forbidden("dgcnn_tpu.io.las") and not _forbidden("dgcnn_tpu_torch.io.las")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("copies")
    write_scene(d / "scene.las", seed=21, extent=(70.0, 50.0), n=30000)
    return d


def _assert_same(a, b):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_load_tile_las_fields_byte_equal(scene):
    ours = tile_load.load_tile_las(str(scene / "scene.las"))
    theirs = jax_tile_load.load_tile_las(str(scene / "scene.las"))
    assert (ours is None) == (theirs is None)
    if ours is not None:
        _assert_same(ours, theirs)
        _assert_same(ours.window_candidates(), theirs.window_candidates())


def test_write_las_bytes_and_read_las_equal(tmp_path):
    rng = np.random.default_rng(3)
    n = 5000
    x, y = rng.random(n) * 100 + 5e5, rng.random(n) * 100 + 6e6
    z, cls = rng.random(n) * 20, rng.integers(0, 7, n)
    intensity = rng.integers(0, 255, n)
    for mod, name in ((las, "ours.las"), (jax_las, "theirs.las")):
        mod.write_las(str(tmp_path / name), x, y, z, cls, intensity=intensity)
    assert (tmp_path / "ours.las").read_bytes() == (tmp_path / "theirs.las").read_bytes()
    _assert_same(las.read_las(str(tmp_path / "ours.las")),
                 jax_las.read_las(str(tmp_path / "ours.las")))


def test_room2blocks_and_sample_data_equal_under_one_seed(scene):
    data = np.column_stack([jax_las.read_las(str(scene / "scene.las")).xyz,
                            np.zeros(30000)])
    labels = np.arange(len(data)) % 5
    for kw in (dict(block_size=20.0, stride=20.0, random_sample=False),
               dict(block_size=20.0, stride=10.0, random_sample=True, sample_num=6),
               dict(block_size=20.0, stride=20.0, return_indices=True)):
        ours = blocks.room2blocks(data, labels, 512, rng=np.random.default_rng(4), **kw)
        theirs = jax_blocks.room2blocks(data, labels, 512, rng=np.random.default_rng(4), **kw)
        _assert_same(list(ours) if isinstance(ours, tuple) else ours,
                     list(theirs) if isinstance(theirs, tuple) else theirs)
    for n in (100, 3000):
        _assert_same(blocks.sample_data(data[:1000], n, np.random.default_rng(5)),
                     jax_blocks.sample_data(data[:1000], n, np.random.default_rng(5)))


def test_build_dtm_and_gen_agl_equal(scene):
    pc = jax_las.read_las(str(scene / "scene.las")).xyz
    ours = dtm.build_dtm(pc)
    theirs = jax_dtm.build_dtm(pc)
    _assert_same(ours, theirs)
    _assert_same(dtm.gen_agl(ours, pc), jax_dtm.gen_agl(theirs, pc))
    # the numpy engine too, where the native library is bypassed
    _assert_same(dtm.build_dtm(pc[:5000], use_native=False),
                 jax_dtm.build_dtm(pc[:5000], use_native=False))


def test_load_pointcloud_equal(scene):
    feats = {"x": 0, "y": 1, "z": 2, "agl": 3}
    ours = loaders.load_pointcloud(str(scene / "scene.las"), features=feats)
    theirs = jax_loaders.load_pointcloud(str(scene / "scene.las"), features=feats)
    _assert_same(list(ours), list(theirs))


def _norm(tree: ast.AST) -> str:
    """The AST without docstrings, ``dgcnn_tpu_torch`` imports read as
    ``dgcnn_tpu``."""
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(getattr(body[0], "value", None), ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = node.module.replace("dgcnn_tpu_torch.", "dgcnn_tpu.")
    return ast.dump(tree)


def test_copies_are_the_originals_apart_from_imports_and_comments():
    """Function by function, the code of each copy is the original's: the
    ASTs agree once docstrings are dropped and ``dgcnn_tpu`` module names
    in imports read ``dgcnn_tpu_torch``."""
    copies = ("utils/logging.py", "io/las.py", "io/h5.py", "prepare/dtm.py",
              "prepare/noise.py", "prepare/blocks.py", "prepare/loaders.py",
              "prepare/tile_load.py", "data/dataset.py", "data/sampling.py")
    for rel in copies:
        ours = (REPO / "dgcnn_tpu_torch" / rel).read_text()
        theirs = (REPO / "dgcnn_tpu" / rel).read_text()
        assert _norm(ast.parse(ours)) == _norm(ast.parse(theirs)), rel


@pytest.mark.parametrize("rel, name", [("ops/metrics.py", "calculate_sem_iou")])
def test_copied_functions_are_the_originals(rel, name):
    """A function copied into a port module of its own design: its code is
    the original's, docstrings apart."""
    def find(path):
        tree = ast.parse((REPO / path / rel).read_text())
        return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)

    assert _norm(find("dgcnn_tpu_torch")) == _norm(find("dgcnn_tpu"))


def test_copied_serve_directory_writes_what_the_original_writes(tmp_path):
    """The port's serve_directory and the JAX package's, each driving the
    port's PredictService over the same two tiles."""
    k, emb = 20, 64
    p, s = jax_weights(JaxConfig(k=k, emb_dims=emb), seed=4)
    save_checkpoint(str(tmp_path / "ckpt" / "dgcnn_model.npz"), {"params": p, "bn_state": s})
    (tmp_path / "landing").mkdir()
    for i in range(2):
        write_scene(tmp_path / "landing" / f"tile{i}.las", seed=30 + i, extent=(40.0, 20.0),
                    n=9000)
    kw = dict(num_points=1024, block_size=20.0, emb_dims=emb, batch_size=4,
              model_root=str(tmp_path / "ckpt"), device="cpu", knn_impl="pallas_capped",
              knn_band=0, knn_band_feature=0)
    outs = {}
    for name, serve in (("ours", service.serve_directory),
                        ("theirs", jax_service.serve_directory)):
        svc = service.PredictService(k, io=IOStream(str(tmp_path / f"{name}.log")), **kw)
        out = tmp_path / name
        assert serve(svc, str(tmp_path / "landing"), str(out), once=True, settle_s=0.0) == 2
        outs[name] = out
    for i in range(2):
        a = (outs["ours"] / f"tile{i}.las").read_bytes()
        b = (outs["theirs"] / f"tile{i}.las").read_bytes()
        assert a == b
        sa = json.loads((outs["ours"] / f"tile{i}.las.json").read_text())
        sb = json.loads((outs["theirs"] / f"tile{i}.las.json").read_text())
        assert sa.keys() == sb.keys()
        assert (sa["points"], sa["block_points"]) == (sb["points"], sb["block_points"])
    sa = json.loads((outs["ours"] / "status.json").read_text())
    sb = json.loads((outs["theirs"] / "status.json").read_text())
    assert sa.keys() == sb.keys() and sa["processed"] == sb["processed"] == 2
    assert sorted(os.listdir(outs["ours"])) == sorted(os.listdir(outs["theirs"]))
