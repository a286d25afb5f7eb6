"""The benchmark's meshes: binary little-endian PLY files of float32
vertices and uchar/int32 triangle lists (as `port_bench/data/` holds
them), read with their sha256 checked, so that a yardstick's input that
moved is refused and never measured."""

from __future__ import annotations

import hashlib
import os

import numpy as np


def read_ply(path: str):
    """(vertices [V,3] float64, faces [F,3] int64)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    end = raw.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file")
    head = raw[:end].decode("ascii").split("\n")
    counts, props = {}, {}
    elem = None
    for line in head:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "format" and tok[1] != "binary_little_endian":
            raise ValueError(f"{path}: format {tok[1]} is not read here")
        if tok[0] == "element":
            elem = tok[1]
            counts[elem] = int(tok[2])
            props[elem] = []
        elif tok[0] == "property":
            props[elem].append(tok[1:])
    if (props.get("vertex") != [["float", "x"], ["float", "y"], ["float", "z"]]
            or props.get("face") != [["list", "uchar", "int",
                                      "vertex_indices"]]):
        raise ValueError(f"{path}: unexpected properties {props}")
    body = raw[end + len(b"end_header\n"):]
    nv, nf = counts["vertex"], counts["face"]
    v = np.frombuffer(body, dtype="<f4", count=nv * 3).reshape(nv, 3)
    rec = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
    f = np.frombuffer(body, dtype=rec, count=nf, offset=nv * 12)
    if not np.all(f["n"] == 3):
        raise ValueError(f"{path}: a face is not a triangle")
    return v.astype(np.float64), f["i"].astype(np.int64)


def load_mesh(root: str, entry: dict):
    """The mesh of a configuration's entry {"file", "sha256"}, the file's
    path relative to the checkout's root (or absolute), scaled about its
    vertices' centroid by the entry's "scale_about_centroid" where it has
    one."""
    path = os.path.join(root, entry["file"])
    with open(path, "rb") as fh:
        got = hashlib.sha256(fh.read()).hexdigest()
    if got != entry["sha256"]:
        raise ValueError(f"{entry['file']}: sha256 {got}, the configuration "
                         f"states {entry['sha256']}")
    v, f = read_ply(path)
    s = entry.get("scale_about_centroid")
    if s is not None:
        c = v.mean(axis=0)
        v = c + (v - c) * s
    return v, f
