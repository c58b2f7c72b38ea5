"""Build the hand-written CUDA kernels with plain ``nvcc`` and load them with ctypes.

Every ``csrc/<name>.cu`` compiles on first use into its own shared library
``_build/<name>-<hash>.so``, where the hash covers the source, every
shared header ``csrc/*.cuh``, the flags and any ``-D`` defines: a changed
source rebuilds, an unchanged one loads the library already built.  The
build's log, with ptxas's register and shared-memory counts, is kept beside
it as ``<name>-<hash>.log``.  A source may take defines that override its
swept design constants (``#ifndef`` defaults in the ``.cu``); the port builds
every source with none.  Sources include no PyTorch header, so a build takes
seconds.  All sources are compiled at once, one ``nvcc`` process each
(``build_all``).

Nothing here runs when the module is imported: the CPU tests import every
module, and this machine may have no ``nvcc``.  A missing compiler or a failed
build raises; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# argtypes of each library's launchers: c_void_p for pointers and the stream,
# c_int64 for sizes (without them ctypes passes 32-bit ints and cuts pointers),
# c_float for float32 scalars
_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
SIGNATURES = {
    "batch_norm": {
        "hegp_bn_stats": (_P,) * 6 + (_I,) * 6 + (_F,) * 5 + (_I, _I, _P),
        "hegp_bn_finalize": (_P,) * 6 + (_I,) + (_F,) * 4 + (_I, _P),
        "hegp_bn_apply": (_P,) * 4 + (_I,) * 5 + (_P,),
        "hegp_bn_grad_sums": (_P,) * 10 + (_I,) * 7 + (_F, _I, _P),
        "hegp_bn_grad_coef": (_P,) * 7 + (_I, _F, _P),
        "hegp_bn_grad_apply": (_P,) * 6 + (_I,) * 5 + (_P,),
    },
    "dequantize": {"hegp_dequantize_group": (_P, _P, _P, _P, _I, _I, _P)},
    "min_distances": {"hegp_min_distances": (_P, _P, _P, _I, _I, _I, _P)},
    "quantize": {"hegp_quantize_group": (_P, _P, _P, _P, _I, _I, _P)},
    "target_assign": {"hegp_target_assign": (_P,) * 12 + (_I,) * 6 + (_F,) * 3 + (_P,)},
}

_lock = threading.Lock()
_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(cuda_home, "bin", "nvcc")
        if os.access(candidate, os.X_OK):
            nvcc = candidate
    if nvcc is None:
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: cannot build the CUDA kernels")
    return nvcc


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _digest(name: str, defines: Tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    for f in sorted(os.listdir(CSRC)):
        if f == f"{name}.cu" or f.endswith(".cuh"):
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(f.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def library_path(name: str, defines: Tuple[str, ...] = ()) -> str:
    """``defines``: ``NAME=VALUE`` strings passed to nvcc as ``-D``."""
    return os.path.join(BUILD_DIR, f"{name}-{_digest(name, defines)}.so")


def _start(nvcc: str, name: str, defines: Tuple[str, ...] = ()) -> Optional[Tuple[subprocess.Popen, str, str]]:
    """Start one nvcc for ``name`` unless its library is already built."""
    out = library_path(name, defines)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out[:-3]}.{os.getpid()}.tmp.so"
    cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started: Optional[Tuple[subprocess.Popen, str, str]], timeout: float) -> None:
    if started is None:
        return
    proc, tmp, out = started
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc for {name}.cu did not finish within {timeout} s")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu (rc {proc.returncode}):\n{log}")
    with open(f"{out[:-3]}.log", "w") as f:
        f.write(log)
    os.replace(tmp, out)


def build_all(timeout: float = 300.0, variants: Iterable[Tuple[str, Tuple[str, ...]]] = ()) -> List[str]:
    """Compile every source not built yet, and each (source, defines) of
    ``variants``, all in parallel; returns the names of the sources built."""
    nvcc = find_nvcc()
    jobs = [(name, ()) for name in sources()] + [(name, tuple(defines)) for name, defines in variants]
    with _lock:
        started = {job: _start(nvcc, *job) for job in jobs}
        for (name, _), s in started.items():
            _finish(name, s, timeout)
    return sorted(name for (name, defines), s in started.items() if s is not None and not defines)


def library(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``defines``, built first if needed."""
    key = (name, tuple(defines))
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            path = library_path(*key)
            if not os.path.exists(path):
                _finish(name, _start(find_nvcc(), *key), 300.0)
            lib = ctypes.CDLL(path)
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _loaded[key] = lib
    return lib
