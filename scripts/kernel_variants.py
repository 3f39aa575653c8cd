"""Patched builds of the port's CUDA sources, shared by the
``exp_*_variants.py`` scripts.

A variant is a list of text replacements applied to a copy of ``csrc/``
under ``build/<script>/<NAME>/``; the copy's sources are compiled with the
port's flags (``kernels/_build.py``), one ``nvcc`` each, all started
together, and linked into a library of the variant's own, whose entry
points get the port's ctypes signatures. ``knn_capped.cu`` is always
linked in: it holds ``dgcnn_error_string``, which ``_build.check`` reads.

    started = start_build("name", patches, out_dir, files=("a.cu",), sources=("a.cu",))
    handle, log = finish_build("name", *started)
    lines = ptxas_lines(log, {"mangled_part": "label"})
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

ERROR_SOURCE = "knn_capped.cu"  # holds dgcnn_error_string


def start_build(name: str, patches: list[tuple[str, str]], out_dir: Path,
                files: tuple[str, ...], sources: tuple[str, ...], csrc: Path | None = None):
    """Copy ``csrc/`` (or ``csrc``, another tree's) to ``out_dir / name``,
    apply each ``(old, new)`` of ``patches`` to the first of ``files`` that
    holds ``old`` (ValueError where none does), and start one ``nvcc -c``
    per source (``sources`` and :data:`ERROR_SOURCE`). Returns what
    :func:`finish_build` takes."""
    from dgcnn_tpu_torch.kernels import _build

    src_dir = out_dir / name
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(csrc or _build.CSRC, src_dir)
    for old, new in patches:
        src = next((src_dir / f for f in files if old in (src_dir / f).read_text()), None)
        if src is None:
            raise ValueError(f"{name}: {old!r} is not in {', '.join(files)}")
        src.write_text(src.read_text().replace(old, new))
    srcs = tuple(dict.fromkeys((*sources, ERROR_SOURCE)))
    procs = [subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-c", "-o", str(src_dir / f"{src}.o"),
         str(src_dir / src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in srcs]
    return src_dir, srcs, procs


def finish_build(name: str, src_dir: Path, srcs: tuple[str, ...], procs):
    """Wait for the compilers, link ``lib.so`` and load it, every entry
    point of ``_build.SIGNATURES`` it exports typed. Returns the handle and
    the compiler's log (``-Xptxas -v``) of the first source."""
    from dgcnn_tpu_torch.kernels import _build

    logs = [p.communicate(timeout=900)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError(f"{name}: nvcc failed\n" + "\n".join(logs))
    so = src_dir / "lib.so"
    subprocess.run([_build.nvcc_path(), "-shared", "-o", str(so),
                    *(str(src_dir / f"{s}.o") for s in srcs)], check=True, timeout=300)
    handle = ctypes.CDLL(str(so))
    for fn, argtypes in _build.SIGNATURES.items():
        if hasattr(handle, fn):
            getattr(handle, fn).argtypes = list(argtypes)
            getattr(handle, fn).restype = ctypes.c_int
    handle.dgcnn_error_string.argtypes = [ctypes.c_int]
    handle.dgcnn_error_string.restype = ctypes.c_char_p
    return handle, logs[0]


def ptxas_lines(log: str, keep: dict[str, str | None]) -> list[str]:
    """The register, stack and spill lines of the entry functions whose
    mangled name holds a key of ``keep``, each after that key's label (its
    mangled name where the label is None)."""
    lines, hit = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            key = next((k for k in keep if k in line), None)
            hit = key is not None
            if hit:
                lines.append(keep[key] or line.split("'")[1])
        elif hit and ("Used" in line or "spill" in line):
            lines.append(line.strip())
    return lines
