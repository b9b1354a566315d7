"""Minimal PCD (Point Cloud Data v0.7) reader/writer for xyz float32.

The port's own copy of the JAX package's io/pcd.py (numpy only): files
either package writes, the other reads. Interop with the reference's
per-keyframe .pcd persistence (keyframe.cpp:53-110 uses
pcl::io::savePCDFileBinary) and with standard PCL tooling.
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np

_HEADER = """# .PCD v0.7 - Point Cloud Data file format
VERSION 0.7
FIELDS x y z
SIZE 4 4 4
TYPE F F F
COUNT 1 1 1
WIDTH {n}
HEIGHT 1
VIEWPOINT 0 0 0 1 0 0 0
POINTS {n}
DATA {mode}
"""


def save_pcd(path, points: np.ndarray, binary: bool = True) -> None:
    pts = np.ascontiguousarray(np.asarray(points, np.float32)[:, :3])
    mode = "binary" if binary else "ascii"
    with open(path, "wb") as f:
        f.write(_HEADER.format(n=len(pts), mode=mode).encode())
        if binary:
            f.write(pts.tobytes())
        else:
            np.savetxt(f, pts, fmt="%.6f")


def load_pcd(path) -> np.ndarray:
    raw = Path(path).read_bytes()
    header_end = 0
    fields, sizes, types, counts = [], [], [], []
    n_points, mode = 0, "ascii"
    stream = io.BytesIO(raw)
    while True:
        line = stream.readline()
        if not line:
            raise ValueError(f"{path}: truncated PCD header")
        text = line.decode("ascii", "replace").strip()
        if text.startswith("#") or not text:
            continue
        key, _, val = text.partition(" ")
        if key == "FIELDS":
            fields = val.split()
        elif key == "SIZE":
            sizes = [int(v) for v in val.split()]
        elif key == "TYPE":
            types = val.split()
        elif key == "COUNT":
            counts = [int(v) for v in val.split()]
        elif key == "POINTS":
            n_points = int(val)
        elif key == "DATA":
            mode = val
            header_end = stream.tell()
            break
    if mode == "ascii":
        data = np.loadtxt(io.BytesIO(raw[header_end:]), dtype=np.float32,
                          ndmin=2)
        cols = {f: i for i, f in enumerate(fields)}
        return data[:, [cols["x"], cols["y"], cols["z"]]]
    # binary: build a struct dtype from the header
    np_types = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1",
                ("U", 2): "u2", ("U", 4): "u4", ("I", 1): "i1",
                ("I", 2): "i2", ("I", 4): "i4"}
    dt = np.dtype([
        (f or f"_{i}", np_types[(t, s)], (c,) if c > 1 else ())
        for i, (f, s, t, c) in enumerate(zip(fields, sizes, types, counts))])
    arr = np.frombuffer(raw[header_end:header_end + n_points * dt.itemsize],
                        dtype=dt, count=n_points)
    return np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float32)
