"""The row kernels' share of their roofline, in %: the bound of each
traced step's gathers, row scatter and tail scatter over their device
time."""

from harness.readers import roofline


def read(obs):
    return roofline(obs, ("gather", "scatter", "tail"), "training", "steps")
