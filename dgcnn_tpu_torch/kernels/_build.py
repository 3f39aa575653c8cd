"""Build and load the port's CUDA kernels (``csrc/*.cu``, with the shared
``csrc/*.cuh`` headers) at first use.

The sources are compiled by ``nvcc``, one process per source, all at once,
and linked into one shared library with a plain C interface, loaded
through :mod:`ctypes` (no PyTorch headers, so a build takes seconds, not
minutes). The library goes to ``build/dgcnn_tpu_torch/``
at the root of the checkout, named by a hash of the sources and flags, so
a stale library is never loaded; it is written under a temporary name and
renamed into place, so concurrent first uses cannot load a partial file.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dgcnn_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points (see csrc/*.cu): argument types, all returning cudaError_t
SIGNATURES = {
    "dgcnn_knn_capped": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _P),
    "dgcnn_knn_banded": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _P),
    "dgcnn_knn_exact": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "dgcnn_knn_exact_banded": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _P),
    "dgcnn_knn_packed": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P),
    "dgcnn_knn_packed_split": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _P),
    "dgcnn_gather_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
    "dgcnn_edgeconv_stage": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _P),
    "dgcnn_edgeconv_stage_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _P),
    "dgcnn_edgeconv_extrema": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "dgcnn_scatter_add_rows": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "dgcnn_scatter_stage_tail": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of "
            "dgcnn_tpu_torch are compiled from source at first use")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):  # headers too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdgcnn_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists;
    returns its path. The compiler's output (register and shared-memory
    use per kernel) is kept beside it as ``<name>.log``."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(_sources(), objs)]
        logs = []
        for src, proc in zip(_sources(), procs):
            try:
                out, _ = proc.communicate(timeout=900)
            except subprocess.TimeoutExpired:
                for p in procs:
                    p.kill()
                raise
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                for p in procs:
                    p.kill()
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{out}")
        so = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, "-shared", "-o", so, *objs],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        path.with_suffix(".log").write_text("\n".join(logs))
        os.replace(so, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        handle.dgcnn_error_string.argtypes = [ctypes.c_int]
        handle.dgcnn_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


KERNEL_WIDTHS = (4, 8, 16, 32, 64)  # the kNN kernels' channel templates


def kernel_width(c: int) -> int:
    """The kNN kernels' channel width for ``c`` channels: rows are
    zero-padded up to it (zeros change no dot or norm)."""
    cv = next((w for w in KERNEL_WIDTHS if w >= c), None)
    if cv is None:
        raise ValueError(f"the CUDA kNN kernels take at most {KERNEL_WIDTHS[-1]} channels, not {c}")
    return cv


def predicate(pred: "torch.Tensor | None",
              device: torch.device) -> "torch.Tensor | None":
    """A kernel's optional device predicate as the int32 tensor whose
    pointer the launcher takes (``None``: always run). ``pred`` is a 0-d
    bool tensor on the kernel's device: a decision that stays on the device,
    so taking it needs no host sync. The caller keeps the result alive
    until the launch is queued."""
    if pred is None:
        return None
    if pred.dim() != 0 or pred.dtype != torch.bool or pred.device != device:
        raise ValueError(f"a predicate is a 0-d bool tensor on {device}, not "
                         f"{pred.dtype} {tuple(pred.shape)} on {pred.device}")
    return pred.to(torch.int32)


def skipped(pred: "torch.Tensor | None") -> bool:
    """On the CPU: whether a plain version's predicate says not to run
    (a host read, free there)."""
    return pred is not None and not bool(pred)


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a non-zero cudaError_t."""
    if err:
        msg = lib().dgcnn_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
