"""Build the port's CUDA kernels from ``ddl_tpu_torch/csrc`` with ``nvcc``.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` launcher and no PyTorch
headers, so ``nvcc`` builds it in seconds into a shared library that
``ctypes`` loads. Libraries go to ``ddl_tpu_torch/_build/`` (git-ignored),
named by a hash of the source, the ``csrc/*.cuh`` headers it includes and
the flags, so an edited source or header is rebuilt and an unchanged one is
reused. Nothing is built when a module is imported:
the first launch on a CUDA tensor builds, and ``build_all`` builds every
kernel at once (one ``nvcc`` per source, all started together).

A missing ``nvcc`` or a failed build raises: no caller falls back to the
plain PyTorch version on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"

# sm_90a: Hopper with its architecture-specific features. No
# --use_fast_math: the kernels round exactly as their plain versions.
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

KERNEL_SOURCES = ("fused_adam", "flash_attention")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from ddl_tpu_torch/csrc at first use"
    )


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: pathlib.Path, seen: dict[pathlib.Path, bytes]) -> None:
    """``path`` and every header it includes with quotes (relative to the
    including file, recursively), each read once."""
    path = path.resolve()
    if path in seen:
        return
    seen[path] = text = path.read_bytes()
    for inc in _LOCAL_INCLUDE.findall(text):
        _sources(path.parent / inc.decode(), seen)


def library_path(name: str) -> pathlib.Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the flags, the
    source and the local headers it includes, so an edit to any of them
    builds anew."""
    seen: dict[pathlib.Path, bytes] = {}
    _sources(CSRC / f"{name}.cu", seen)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path, text in seen.items():
        digest.update(path.name.encode() + b"\0" + text)
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path] | None:
    """Start ``nvcc`` for one source unless its library exists. Writes to
    a per-process temporary name, renamed into place when done, so
    concurrent builders never load a half-written library."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: tuple[str, ...] = KERNEL_SOURCES) -> None:
    """Build every named kernel library, all ``nvcc`` runs in parallel."""
    with _lock:
        jobs = {n: _start(n) for n in names if n not in _loaded}
        errors = []
        for n, job in jobs.items():
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]
