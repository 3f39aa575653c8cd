"""What every cell shares: the files found by name, the card, host spans,
the result line.

Layout (all found by the names in ``BENCHMARK.json``):

* ``benchmark/configs/<config>.json``: ``architecture`` (the model's name,
  which finds the two files below; a configuration without it is an
  error), the model knobs (``model``), the input ``features``, the serving
  and training settings, the ``precision`` whose peak the work is held to;
* ``benchmark/workloads/<cell>.json``: ``config``, ``traffic``, the traffic
  kind's ``params`` and the ``limits`` of the comparison;
* ``benchmark/traffic/<kind>.py``: ``run(ctx) -> dict`` drives the cell
  with the architecture's pieces (``ctx["arch"]``);
* ``benchmark/metrics/<metric>.py``: ``read(obs) -> float | None``;
* ``benchmark/work/<architecture>.py``: the model's least work, from the
  configuration and the shapes alone: ``shapes(cfg, batch, points) -> s``,
  ``inference_sites(s)`` and ``training_sites(s)`` (kernel family ->
  ``(work, calls)`` a batch or a step, ``work`` a dict of ``flops`` and
  ``bytes``; ``harness/peaks.py::bound_s`` turns it into seconds),
  ``forward_flops(s)`` (a batch) and ``train_flops(s)`` (a step), and
  optionally ``KERNEL_GROUPS``, ``(kernel-name fragment, family)`` pairs
  that the trace matches before its own table (``harness/trace.py``);
* ``benchmark/arch/<architecture>.py``: the model's pieces for the shared
  traffic loops: ``Pieces(cfg, overrides, seed, device)`` (the model
  ``module`` with its weights from the seed, ``weights`` as made,
  ``num_classes``, and a ``tap`` with ``armed`` and ``take()``, the
  graphs of the armed dispatches for the check), ``serve(conf,
  unclassified)``, then ``tile()`` a tile (``step(points) -> (pred,
  probs, logits)``, ``suspects()`` the dispatches to re-run after the
  drain, ``rerun(points)``, ``tripped``) and ``warm_rerun(points)``;
  ``train_step()`` (``step(state, points, labels, mask, *mode) ->
  metrics`` with ``loss`` and ``confusion``, and a guarded step's
  ``band_tripped``), ``next_mode() -> (mode, guarded)``, ``observe(flag)``
  and ``rearm()`` (each pass over the pool); and the two judges,
  ``judge_tiles(samples, weights, cfg, device)`` and
  ``judge_train(weights, batches, idxs, dropout_seed, program, cfg,
  device)``, against the architecture's plain reference (DGCNN's under
  ``reference/``). An architecture without a guard returns no suspects and
  the mode ``()``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dgcnn_tpu")


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str) -> dict:
    """The ``workloads`` entry of ``BENCHMARK.json`` named ``name``."""
    for w in spec()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def read_json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def architecture(cfg: dict, name: str) -> str:
    """The architecture configuration ``name`` (its file ``cfg``) names."""
    if "architecture" not in cfg:
        raise KeyError(f"benchmark/configs/{name}.json names no \"architecture\"")
    return cfg["architecture"]


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    mod_name = f"bench_{kind}_{name.replace('.', '_')}"
    mod_spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[mod_name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def generator(seed: int, device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (any whole
    number: taken modulo 2**63)."""
    import torch

    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def end_to_end_of(name: str) -> list[dict]:
    """The end-to-end metrics cell ``name`` reports."""
    return [m for m in spec()["end_to_end"] if name in m.get("workloads", [name])]


def per_layer_of(name: str) -> list[dict]:
    """The per-layer metrics cell ``name`` reports: those that list it, and
    those without a list whose ``moves`` metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_of(name)}
    return [m for m in spec()["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Spans:
    """Host spans of the harness's own calls into the program: seconds by
    name, and, while ``profiling``, ``torch.profiler`` ranges of the same
    names so the trace can say what the host did in each idle gap."""

    def __init__(self):
        self.seconds: dict[str, list[float]] = {}
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = None
        if self.profiling:
            from torch.profiler import record_function

            rf = record_function(f"bench.{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)

    def mean_ms(self, name: str) -> float | None:
        v = self.seconds.get(name)
        return 1e3 * sum(v) / len(v) if v else None


def checks_line(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: each number beside its limit; a number that is
    missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        passed = isinstance(v, float | int) and math.isfinite(v) and v <= limit
        ok &= passed
        checks[name] = {"value": v if math.isfinite(v) else str(v), "limit": limit}
    return ok, checks
