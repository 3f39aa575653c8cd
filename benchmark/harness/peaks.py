"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit)."""

from __future__ import annotations

H100 = {
    "bytes_per_s": 3.35e12,  # HBM3
    "flops_per_s": {
        "float32": 67e12,  # outside the tensor cores
        "tf32": 495e12,
        "bfloat16": 989e12,
        "float16": 989e12,
    },
}

CARDS = {"H100": H100}


def peaks(kind: str, precision: str) -> dict:
    """``{"flops_per_s", "bytes_per_s"}`` of the card named ``kind`` (as
    ``torch.cuda.get_device_name`` gives it) at ``precision``. Raises
    ``KeyError`` for a card the table lacks."""
    card = next((v for name, v in CARDS.items() if name in kind), None)
    if card is None:
        raise KeyError(f"no published peaks for {kind!r}")
    return {"flops_per_s": card["flops_per_s"][precision], "bytes_per_s": card["bytes_per_s"]}


def bound_s(work: dict, peaks: dict) -> float:
    """The least seconds the card could take for ``work`` (``flops``,
    ``bytes``): the larger of operations over the peak rate and bytes over
    the peak bandwidth."""
    return max(work["flops"] / peaks["flops_per_s"], work["bytes"] / peaks["bytes_per_s"])
