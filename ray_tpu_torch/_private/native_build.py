"""Content-hash-gated builds of the C++ runtime components.

Artifacts are compiled into ``ray_tpu_torch/cpp/build/`` (never committed) with
the source digest in the filename, so a checkout can never load a stale or
foreign binary: a changed source hashes to a new path and rebuilds; the
mtime of files restored by git is irrelevant.

The port's copy of ``ray_tpu/_private/native_build.py``.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import threading

_lock = threading.Lock()


def build_native(
    src: str,
    out_name: str,
    compile_args: list[str],
    link_args: list[str] | None = None,
) -> str:
    """Compile ``src`` with g++ if no artifact for its current content
    exists; returns the artifact path. Safe under concurrent callers
    (atomic rename; same digest converges to the same path)."""
    with _lock:
        # no memoized early-return: the digest MUST be recomputed per call
        # or an in-process edit to a header would keep serving the stale
        # binary; hashing a few small sources is microseconds
        hasher = hashlib.sha256()
        with open(src, "rb") as f:
            hasher.update(f.read())
        # sibling headers are part of the translation unit: an edit to
        # util.hpp must rebuild every binary that includes it
        src_dir = os.path.dirname(src)
        for name in sorted(os.listdir(src_dir)):
            if name.endswith((".hpp", ".h")):
                with open(os.path.join(src_dir, name), "rb") as f:
                    hasher.update(f.read())
        digest = hasher.hexdigest()[:12]
        build_dir = os.path.join(os.path.dirname(src), "build")
        os.makedirs(build_dir, exist_ok=True)
        out = os.path.join(build_dir, f"{out_name}.{digest}")
        if not os.path.exists(out):
            tmp = f"{out}.tmp.{os.getpid()}"
            subprocess.run(
                ["g++", *compile_args, "-o", tmp, src, *(link_args or [])],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, out)
        return out
