"""The share of the window's tiles whose recall guard tripped
(``BandGuardScheduler.tripped``), in %."""


def read(obs):
    w = obs["window"]
    return 100.0 * w["tripped"] / w["tiles"] if w.get("tiles") else None
