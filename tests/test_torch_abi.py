"""The ctypes bindings of the port's CUDA kernels against their C sources,
on the CPU: every ``extern "C"`` entry point of
``dgcnn_tpu_torch/kernels/csrc/*.cu`` has its argument types in
``kernels/_build.py::SIGNATURES``, one per parameter, ``c_void_p`` for
each pointer (the stream too) and ``c_int`` for each ``int``. ctypes
checks nothing against the library, so a missing or extra argument would
pass garbage to a kernel without an error."""

import ctypes
import re

import pytest

from dgcnn_tpu_torch.kernels import _build

_ENTRY = re.compile(r'extern\s+"C"\s+(.+?)\b(dgcnn_\w+)\s*\(([^)]*)\)\s*\{', re.S)


def _entry_points() -> dict[str, tuple[str, list[str]]]:
    """name -> (return type, parameter declarations) of every entry point."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for ret, name, params in _ENTRY.findall(src.read_text()):
            assert name not in found, f"{name} defined twice"
            decls = [" ".join(p.split()) for p in params.split(",") if p.strip()]
            found[name] = (" ".join(ret.split()), decls)
    return found


ENTRY_POINTS = _entry_points()


def _ctype(decl: str):
    """The ctypes type a C parameter declaration needs."""
    if "*" in decl:
        return ctypes.c_void_p
    if re.fullmatch(r"(const )?int \w+", decl):
        return ctypes.c_int
    raise AssertionError(f"no ctypes rule for the parameter {decl!r}")


def test_every_entry_point_is_bound():
    kernels = {n for n, (ret, _) in ENTRY_POINTS.items() if ret == "int"}
    assert kernels == set(_build.SIGNATURES)
    # the one other entry point: the error string the wrappers raise with
    assert set(ENTRY_POINTS) - kernels == {"dgcnn_error_string"}
    assert ENTRY_POINTS["dgcnn_error_string"] == ("const char*", ["int err"])


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_argtypes_match_the_c_parameters(name):
    ret, decls = ENTRY_POINTS[name]
    assert ret == "int"  # a cudaError_t, the restype lib() sets
    want = [_ctype(d) for d in decls]
    assert list(_build.SIGNATURES[name]) == want, (name, decls)
    assert decls[-1] == "void* stream"  # every launcher takes the stream last
