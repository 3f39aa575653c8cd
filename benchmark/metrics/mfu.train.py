"""The model operations of the steps completed in the window
(``work/dgcnn.py::train_flops``) over the window times the configuration's
peak, in %."""


def read(obs):
    w = obs["window"]
    if not w.get("steps"):
        return None
    return 100.0 * w["steps"] * obs["train_flops_per_step"] / (w["window_s"] * obs["peak_flops"])
