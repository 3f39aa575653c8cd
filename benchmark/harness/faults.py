"""Faults planted under a run, for the checks that ``correct`` catches
them (``calibrate.py`` on the card, ``tests/`` on the CPU); a benchmark run
plants none.

* ``half``: half of the batch left out: the forward runs on the first half
  and its outputs stand in for the rest; a train step on the first half,
  the mean taken over it;
* ``unchanged``: a train step that leaves its state unchanged (the
  optimizer's update skipped);
* ``alter``: an answer altered where it is produced: the first block's
  logits rolled by one class; in training, the first block's labels.
"""

from __future__ import annotations

FAULTS = ("half", "unchanged", "alter")


class Fault:
    def __init__(self, name: str):
        if name not in FAULTS:
            raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
        self.name = name

    def plant_tiles(self, model) -> None:
        import torch

        forward = model.forward

        def broken(x, *args, **kwargs):
            if self.name == "half":
                h = max(x.shape[0] // 2, 1)
                out = forward(x[:h], *args, **kwargs)
                logits = out[0] if isinstance(out, tuple) else out
                logits = torch.cat([logits, logits], 0)[:x.shape[0]]
                return (logits, out[1]) if isinstance(out, tuple) else logits
            out = forward(x, *args, **kwargs)
            if self.name == "alter":
                logits = out[0] if isinstance(out, tuple) else out
                logits[0] = logits[0].roll(1, dims=-1)
            return out

        model.forward = broken

    def plant_train(self, step, state):
        if self.name == "unchanged":
            state.optimizer.step = lambda *a, **k: None
            return step

        def broken(st, x, y, m, *mode):
            if self.name == "half":
                h = max(x.shape[0] // 2, 1)
                return step(st, x[:h], y[:h], m[:h], *mode)
            y = y.clone()
            y[0] = (y[0] + 1) % int(y.max() + 1)
            return step(st, x, y, m, *mode)

        return broken
