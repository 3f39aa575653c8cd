"""Arithmetic the per-layer readers share. ``obs`` holds the driver's
untraced ``window`` (counts, ``window_s``, ``host_ms`` by span), its
``trace`` (``groups`` of device seconds, ``busy_s``, ``window_s`` and the
``dispatches`` or ``steps`` it covered; None without ``--trace 1``), and
``bounds`` (seconds a batch or a step, by kernel family, at the card's
peaks, from ``work/``)."""

from __future__ import annotations


def per_unit_ms(obs: dict, group: str, unit: str) -> float | None:
    """Device ms in ``group`` per ``unit`` ("dispatches" or "steps") of the
    traced stretch; None where the trace holds no such unit."""
    tr = obs.get("trace") or {}
    n = tr.get(unit)
    if not n:
        return None
    return 1e3 * tr["groups"].get(group, 0.0) / n


def roofline(obs: dict, families: tuple, site: str, unit: str) -> float | None:
    """100 x the bound of the families' calls over their device time, over
    the families that ran; None where none ran."""
    tr = obs.get("trace") or {}
    n = tr.get(unit)
    ran = [f for f in families if tr.get("groups", {}).get(f, 0.0) > 0.0] if n else []
    if not ran:
        return None
    bound = sum(n * obs["bounds"][site][f] for f in ran)
    return 100.0 * bound / sum(tr["groups"][f] for f in ran)


def idle_share(obs: dict, unit: str) -> float | None:
    tr = obs.get("trace") or {}
    if not tr.get(unit) or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
