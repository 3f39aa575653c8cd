"""Device ms per train step in cuBLAS's GEMM kernels (by name), traced."""

from harness.readers import per_unit_ms


def read(obs):
    return per_unit_ms(obs, "gemm", "steps")
