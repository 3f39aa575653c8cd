"""The kNN kernels' share of their roofline, in %: the bound of the
three exact all-pairs graphs of each traced batch over the device time of
the port's kNN kernels (every route, probes and repairs included)."""

from harness.readers import roofline


def read(obs):
    return roofline(obs, ("knn",), "inference", "dispatches")
