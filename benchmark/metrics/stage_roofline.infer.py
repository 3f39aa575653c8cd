"""The fused EdgeConv kernels' share of their roofline, in %: the bound
of each traced batch's two stage calls and one extrema call over their
device time."""

from harness.readers import roofline


def read(obs):
    return roofline(obs, ("stage", "extrema"), "inference", "dispatches")
