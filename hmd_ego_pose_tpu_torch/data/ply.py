"""Minimal PLY mesh vertex reader (ascii and binary little-endian).

Copy of ``hmd_ego_pose_tpu/data/ply.py``, unchanged: only the vertex x/y/z
of the dataset's object models are read.
"""

from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply_vertices(path: str) -> np.ndarray:
    """Read the vertex element of a PLY file -> float64 (N, 3) xyz array."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")

        fmt = None
        elements = []  # (name, count, [(prop_name, dtype_str)])
        cur_props = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                cur_props = []
                elements.append((tokens[1], int(tokens[2]), cur_props))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    cur_props.append((tokens[-1], ("list", _PLY_TYPES[tokens[2]], _PLY_TYPES[tokens[3]])))
                else:
                    cur_props.append((tokens[-1], _PLY_TYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

        for name, count, props in elements:
            if name != "vertex":
                # vertex is conventionally the first element; bail if not
                raise ValueError(f"{path}: expected vertex element first, got {name}")
            if any(isinstance(t, tuple) for _, t in props):
                raise ValueError(f"{path}: list property in vertex element unsupported")

            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append([float(v) for v in f.readline().split()])
                data = np.asarray(rows)
                names = [p for p, _ in props]
                idx = [names.index(ax) for ax in ("x", "y", "z")]
                return data[:, idx].astype(np.float64)
            else:
                dtype = np.dtype([(p, "<" + t) for p, t in props])
                data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
                return np.stack(
                    [data["x"], data["y"], data["z"]], axis=-1
                ).astype(np.float64)

    raise ValueError(f"{path}: no vertex element found")
