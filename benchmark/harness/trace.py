"""The device side of a traced window, from ``torch.profiler``.

Device operations are grouped by kernel name (first match wins): the
architecture's own kernel families (``KERNEL_GROUPS`` of ``work/``, matched
first), the port's kernels by family, cuBLAS's GEMMs, copies, and
everything else that PyTorch launches (elementwise, reductions, sort).
Busy time is the union of the device intervals inside the harness's
``bench.window`` range; an idle gap is an interval of it with no device
operation, named by the innermost ``bench.*`` range of the host at the
gap's start.
"""

from __future__ import annotations

import contextlib

# kernel-name fragments -> group, first match wins
GROUPS = (
    ("knn_", "knn"),
    ("edgeconv_stage", "stage"),
    ("edgeconv_extrema", "extrema"),
    ("gather_rows_kernel", "gather"),
    ("scatter_rows_kernel", "scatter"),
    ("scatter_tail", "tail"),
    ("gemm", "gemm"),
    ("gemv", "gemm"),
    ("nvjet", "gemm"),
    ("xmma", "gemm"),
    ("splitkreduce", "gemm"),
    ("memcpy", "copy"),
    ("memset", "copy"),
)
PORT_GROUPS = ("knn", "stage", "extrema", "gather", "scatter", "tail")
OTHER = "torch_ops"
NOT_PORT = {g for _, g in GROUPS if g not in PORT_GROUPS} | {OTHER}


def group(name: str, declared: tuple = ()) -> str:
    """The group of kernel ``name``: the first ``(fragment, family)`` of
    ``declared``, then of :data:`GROUPS`, whose fragment it holds."""
    low = name.lower()
    return next((g for frag, g in (*declared, *GROUPS) if frag in low), OTHER)


def declared_groups(work) -> tuple:
    """The ``KERNEL_GROUPS`` of an architecture's ``work/`` module (none:
    ``()``). Its families count as the port's, so none may take the name
    of a group that is not (:data:`NOT_PORT`)."""
    declared = tuple(getattr(work, "KERNEL_GROUPS", ()))
    clash = {g for _, g in declared} & NOT_PORT
    if clash:
        raise ValueError(f"KERNEL_GROUPS of {work.__file__} name groups that are not the "
                         f"port's: {sorted(clash)}")
    return declared


@contextlib.contextmanager
def profiled(spans, declared: tuple = ()):
    """Profile the block (host and device activity) and yield a dict that is
    filled with :func:`summary` when the block ends; ``declared`` as in
    :func:`group`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    out: dict = {}
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    spans.profiling = True
    with profile(activities=activities) as prof:
        with record_function("bench.window"):
            yield out
            if cuda:
                torch.cuda.synchronize()
    spans.profiling = False
    out.update(summary(prof.events(), declared))


def _union(intervals):
    merged = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged


def summary(events, declared: tuple = ()) -> dict:
    """``window_s``, ``busy_s``, ``groups`` (seconds by group), ``launches``
    (by group), ``device_ops`` and ``idle_gaps`` (name, seconds; longest
    first) of a profile whose host side holds one ``bench.window`` range;
    ``declared`` as in :func:`group`."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    window = [e for e in events if e.name == "bench.window" and e.device_type != cuda]
    if not window:
        return {}
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    dev, ranges = [], []
    for e in events:
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            # the host ranges' projections on the device timeline are no
            # device operations
            if e.name.startswith("bench.") or e.name.startswith("ProfilerStep"):
                continue
            if t1 > t0 and t1 > w0 and t0 < w1:
                dev.append((max(t0, w0), min(t1, w1), e.name))
        elif e.name.startswith("bench.") and e.name != "bench.window":
            ranges.append((t0, t1, e.name[len("bench."):]))
    groups: dict[str, float] = {}
    launches: dict[str, int] = {}
    for t0, t1, name in dev:
        g = group(name, declared)
        groups[g] = groups.get(g, 0.0) + (t1 - t0) * 1e-6
        launches[g] = launches.get(g, 0) + 1
    merged = _union([(t0, t1) for t0, t1, _ in dev])
    busy = sum(t1 - t0 for t0, t1 in merged)
    gaps, cur = [], w0
    for t0, t1 in merged + [[w1, w1]]:
        if t0 > cur:
            gaps.append((cur, t0))
        cur = max(cur, t1)
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        inside = [r for r in ranges if r[0] <= g0 < r[1]]
        name = min(inside, key=lambda r: r[1] - r[0])[2] if inside else "outside a harness span"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "groups": groups,
        "launches": launches,
        "device_ops": sorted(groups.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:10],
    }
