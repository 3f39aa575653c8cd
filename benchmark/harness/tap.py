"""A tap on the model's kNN call."""

from __future__ import annotations


class KnnTap:
    """Records the neighbour indices of the dispatches it is armed for, by
    wrapping the model's kNN call: the graphs the check follows."""

    def __init__(self, model):
        self.armed = False
        self.taken: list = []
        inner = model._knn

        def knn(*args, **kwargs):
            res = inner(*args, **kwargs)
            if self.armed:
                self.taken.append(res[0] if isinstance(res, tuple) else res)
            return res

        model._knn = knn

    def take(self) -> list:
        out, self.taken, self.armed = self.taken, [], False
        return out
