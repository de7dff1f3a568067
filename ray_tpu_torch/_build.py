"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). The library's file name
carries a digest of its source and of every ``csrc/*.cuh`` header, so an
edited source rebuilds and a stale library is never loaded. Libraries go
to ``csrc/build/`` (listed in ``.gitignore``). All sources are compiled
together, one ``nvcc`` process each, the first time any kernel is asked
for. A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Kernel names, one per ``csrc/<name>.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    cand = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(cand):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels build "
            "only where the CUDA toolkit is installed"
        )
    return cand


def _artifact(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        h.update(f.read())
    for hdr in sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, hdr), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}.{h.hexdigest()[:16]}.so")


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, all in parallel;
    returns {name: library path}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: _artifact(name) for name in sources()}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name, path in todo.items():
            tmp = f"{path}.tmp.{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, name + ".cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ), tmp, path)
        errors = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
            else:
                os.replace(tmp, path)
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            for n, path in build_all().items():
                if n not in _libs:
                    _libs[n] = ctypes.CDLL(path)
            lib = _libs[name]
        return lib


# ctypes argument codes of ``bind``: pointers and the stream are "p"
# (void*; a bare ctypes int would cut them to 32 bits), ints "i", floats "f"
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def bind(lib_name: str, fn_name: str, signature: str):
    """The C entry point ``fn_name`` of ``csrc/<lib_name>.cu`` with its
    argument types declared from ``signature`` (one code of ``_CTYPES``
    per argument) and an ``int`` (cudaError_t) result."""
    lib = load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[c] for c in signature]
        fn.restype = ctypes.c_int
    return fn


def raise_on(lib_name: str, kernel: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error; every library exports
    ``<lib_name>_error_string``."""
    if rc != 0:
        err = getattr(load(lib_name), lib_name + "_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{kernel} kernel launch failed: CUDA error {rc} "
            f"({err(rc).decode()})"
        )
