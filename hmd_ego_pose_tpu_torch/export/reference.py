"""Hold an export to the JAX package's: the summary the reference JSON keeps, and the check.

``scripts/make_export_reference.py`` runs the JAX package's ``cli export``
of the shipped artifact and writes ``references/handrel_export.json``:

* the sha256 of the seeded input and the text of the meta JSON;
* for each golden output: its shape, sum, sum of |x|, min, max, and its
  values at the 64 anchors of highest classification and 256 seeded anchors
  (``summarize``);
* the canonical content digest of ``weights_fp32.npz`` and
  ``weights_int8.npz`` (``content_digest``): sha256 over each member's name,
  dtype, shape and C-ordered bytes, in file order, so that two files with
  the same members in the same order agree whatever the memory order numpy
  wrote each array in;
* the relative tolerance of the goldens (``hold``).

``chip_smoke.py`` holds the port's export on the card to that file.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Tuple

import numpy as np

REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "references", "handrel_export.json")
TOP_ANCHORS = 64
SEEDED_ANCHORS = 256


def content_digest(path: str) -> str:
    """sha256 over (name, dtype, shape, C-ordered bytes) of every member of an ``.npz``, in file order."""
    h = hashlib.sha256()
    with np.load(path) as data:
        for name in data.files:
            a = data[name]
            h.update(f"{name}\0{a.dtype.str}\0{a.shape}\0".encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def sample_anchors(classification: np.ndarray, seed: int = 0) -> List[int]:
    """The anchors of the first image to sample: the 64 of highest classification
    score (ties to the lower index), then 256 drawn without replacement."""
    score = classification[0].max(axis=-1)
    top = np.argsort(-score, kind="stable")[:TOP_ANCHORS]
    seeded = np.random.default_rng(seed).choice(score.shape[0], SEEDED_ANCHORS, replace=False)
    return [int(i) for i in np.concatenate([top, seeded])]


def _f32(x) -> float:
    """A float32 as the shortest decimal that reads back to the same float32."""
    return float(str(np.float32(x)))


def summarize(golden: Dict[str, np.ndarray], anchors: List[int]) -> Dict[str, dict]:
    """Per output: shape, sum, sum |x| (float64 over float32 values), min, max,
    and the first image's rows at ``anchors``."""
    out = {}
    for key in sorted(golden):
        a = np.asarray(golden[key], dtype=np.float32)
        out[key] = {
            "shape": list(a.shape),
            "sum": float(a.astype(np.float64).sum()),
            "abs_sum": float(np.abs(a.astype(np.float64)).sum()),
            "min": _f32(a.min()),
            "max": _f32(a.max()),
            "values": [[_f32(v) for v in a[0, i]] for i in anchors],
        }
    return out


def gaps(got: Dict[str, np.ndarray], want: Dict[str, dict], anchors: List[int]) -> Dict[str, float]:
    """Per output, the largest normalised gap of ``got`` (arrays) against a summary:
    values, min and max over the output's max |x|, sum and sum |x| over its sum |x|."""
    summary = summarize(got, anchors)
    out = {}
    for key, w in want.items():
        g = summary[key]
        if g["shape"] != w["shape"]:
            raise AssertionError(f"{key}: shape {g['shape']}, reference {w['shape']}")
        scale = max(abs(w["min"]), abs(w["max"]), 1e-30)
        mass = max(w["abs_sum"], 1e-30)
        worst = float(np.abs(np.asarray(g["values"]) - np.asarray(w["values"])).max()) / scale
        worst = max(worst, abs(g["min"] - w["min"]) / scale, abs(g["max"] - w["max"]) / scale,
                    abs(g["sum"] - w["sum"]) / mass, abs(g["abs_sum"] - w["abs_sum"]) / mass)
        out[key] = worst
    return out


def hold(got: Dict[str, np.ndarray], reference: dict) -> Tuple[Dict[str, float], List[str]]:
    """(normalised gap per output, the outputs off the reference's tolerance)."""
    worst = gaps(got, reference["outputs"], reference["anchors"])
    tol = reference["tolerance_rel"]
    off = [f"{k}: gap {g:.3g} > {tol[k]:.3g}" for k, g in worst.items() if not g <= tol[k]]
    return worst, off
