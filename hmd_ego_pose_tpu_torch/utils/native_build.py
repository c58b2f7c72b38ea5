"""Build and load the port's host C++ libraries (``native/*.cpp``) on first use.

The JAX package compiles its host C++ (``native/frameio.cpp``) with
``g++ -O3 -march=native -shared -fPIC`` and falls back to numpy where it
cannot.  The port builds its copies with the same compiler and flags, one
library per source, into ``_build/<prefix>-<hash>.so``: the hash covers the
source, the flags and this CPU's model and feature flags (``-march=native``
code must not run on another CPU).  A library is built into a temporary file
and renamed into place, so processes that build at once never load a half
written file.  Without ``g++``, or when the build or the load fails, ``load``
returns None and the caller takes its numpy path.

Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def cpu_identity() -> bytes:
    """The CPU model and feature flags, as ``/proc/cpuinfo`` gives them."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    return b"\n".join(sorted({ln for ln in lines if ln.startswith((b"model name", b"flags"))}))


def library_path(prefix: str, source: str, compiler: str) -> str:
    h = hashlib.sha256(" ".join((compiler,) + FLAGS).encode() + b"\0" + cpu_identity())
    with open(source, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"{prefix}-{h.hexdigest()[:16]}.so")


def _build(source: str, compiler: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out[:-3]}.{os.getpid()}.tmp.so"
    subprocess.run([compiler, *FLAGS, source, "-o", tmp], check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)


def load(prefix: str, source: str, state: Dict, lock: threading.Lock,
         declare: Callable[[ctypes.CDLL], None]) -> Optional[ctypes.CDLL]:
    """The library of ``source``, built first if needed, with ``declare(lib)``
    having set its functions' ``argtypes`` and ``restype``; None without a
    compiler or when the build fails.

    ``state`` (``{"lib": ..., "failed": ...}``) and ``lock`` belong to the
    calling module: the first call builds and loads, later calls return what
    it found.
    """
    with lock:
        if state["lib"] is not None or state["failed"]:
            return state["lib"]
        compiler = shutil.which("g++")
        if compiler is None:
            state["failed"] = True
            return None
        out = library_path(prefix, source, compiler)
        try:
            if not os.path.exists(out):
                _build(source, compiler, out)
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.SubprocessError):
            state["failed"] = True
            return None
        declare(lib)
        state["lib"] = lib
        return lib
