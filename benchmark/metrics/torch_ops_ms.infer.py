"""Device ms per batch in kernels that are neither the port's nor GEMMs:
PyTorch's elementwise, reductions, softmax, concat, sort; traced."""

from harness.readers import per_unit_ms


def read(obs):
    return per_unit_ms(obs, "torch_ops", "dispatches")
