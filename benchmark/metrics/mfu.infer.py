"""The model operations of the blocks classified in the window (real
blocks only, ``work/dgcnn.py::forward_flops``) over the window times the
configuration's peak, in %."""


def read(obs):
    w = obs["window"]
    if not w.get("blocks"):
        return None
    return 100.0 * w["blocks"] * obs["forward_flops_per_block"] / (w["window_s"] * obs["peak_flops"])
