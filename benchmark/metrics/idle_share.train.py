"""The device's idle share of the traced training stretch, in %."""

from harness.readers import idle_share


def read(obs):
    return idle_share(obs, "steps")
