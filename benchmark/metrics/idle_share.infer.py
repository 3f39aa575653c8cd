"""The device's idle share of the traced serving stretch, in %:
1 - union of device operations / the traced window."""

from harness.readers import idle_share


def read(obs):
    return idle_share(obs, "dispatches")
