"""A cell small enough for the CPU: icosphere meshes, a 32x24 capture of
4 views, laid out as a checkout's root (BENCHMARK.json and port_bench/'s
files) in a temporary directory."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def icosphere(subdivisions: int, radius: float = 1.0, squash=(1.0, 1.0, 1.0)):
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t],
         [0, 1, t], [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1],
         [-t, 0, -1], [-t, 0, 1]]
    f = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    verts = [np.asarray(p, np.float64) / np.linalg.norm(p) for p in v]
    for _ in range(subdivisions):
        mid, new = {}, []

        def m(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                p = verts[a] + verts[b]
                verts.append(p / np.linalg.norm(p))
                mid[key] = len(verts) - 1
            return mid[key]
        for a, b, c in f:
            ab, bc, ca = m(a, b), m(b, c), m(c, a)
            new += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        f = new
    return (np.asarray(verts) * radius * np.asarray(squash),
            np.asarray(f, np.int64))


def write_ply(path, v, f):
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(v)}\nproperty float x\nproperty float y\n"
            f"property float z\nelement face {len(f)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    rec = np.zeros(len(f), dtype=[("n", "u1"), ("i", "<i4", (3,))])
    rec["n"], rec["i"] = 3, f
    with open(path, "wb") as fh:
        fh.write(head.encode())
        fh.write(np.asarray(v, "<f4").tobytes())
        fh.write(rec.tobytes())
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def make_root(tmp, optimizer="sgd", precond="none", lr=0.05, limits=None):
    """A checkout root holding a copy of port_bench/ (its code, references,
    mixes and readers; not its meshes or tests) with the cell 'tiny'
    (configuration 'tiny-cfg', mix 'replay-blocks') and its limits, and a
    BENCHMARK.json of that cell alone; returns its path."""
    root = os.path.join(tmp, "root")
    pb = os.path.join(root, "port_bench")
    shutil.copytree(BENCH, pb, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__", "data", "tests"))
    os.makedirs(os.path.join(pb, "data"))
    gt_sha = write_ply(os.path.join(pb, "data", "gt.ply"),
                       *icosphere(3, 10.0, (1.0, 0.8, 1.2)))
    init_sha = write_ply(os.path.join(pb, "data", "init.ply"),
                         *icosphere(2, 10.3, (1.0, 0.8, 1.2)))
    cfg = {
        "name": "tiny-cfg", "source": "a test",
        "rig": {"name": "tiny", "resy": 24, "resx": 32, "num_views": 4,
                "fov_deg": 45.0, "cam_distance_factor": 3.5,
                "screen_distance_factor": 2.5, "elevation_deg": 10.0},
        "ground_truth": {"file": "port_bench/data/gt.ply", "sha256": gt_sha},
        "init_mesh": {"file": "port_bench/data/init.ply",
                      "sha256": init_sha},
        "dtype": "float32", "ior": 1.4723, "ext_ior": 1.00029,
        "ray_w": 40.0, "vh_w": 0.002, "sm_w": 0.08,
        "optimizer": optimizer, "momentum": 0.95, "precond": precond,
        "precond_lambda": 29.0, "cg_iters": 64, "grad_clamp": 1.0,
        "lr": lr, "silhouette_budget": 512, "reduced": []}
    with open(os.path.join(pb, "configs", "tiny-cfg.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(pb, "limits", "tiny.json"), "w") as fh:
        json.dump(limits or {"loss_gap": 1e-4, "grad_gap": 1e-4,
                             "update_gap": 1e-4}, fh)
    man = {"configs": [{"name": "tiny-cfg", "source": "a test",
                        "file": "port_bench/configs/tiny-cfg.json",
                        "reduced": [], "why": "a test"}],
           "workloads": [{"name": "tiny", "config": "tiny-cfg",
                          "traffic": "replay-blocks", "chips": 1,
                          "why": "a test"}],
           "end_to_end": [], "per_layer": []}
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(man, fh)
    return root


class EagerRunner:
    """The interface of the port's GraphedTrainStep with the eager step
    on the CPU: the iteration's rows read by host index, the state
    updated in place."""

    def __init__(self, step, state, lr, mesh, views, ray_idx, silh_idx):
        self.step, self.lr, self.mesh, self.views = step, lr, mesh, views
        self.state = {k: v.clone() for k, v in state.items()}
        self.ray, self.silh = ray_idx.tolist(), silh_idx.tolist()
        self.it = 0
        self.setup = {}

    def __call__(self):
        new, loss, aux = self.step(self.state, self.lr, self.mesh,
                                   self.views, self.ray[self.it],
                                   self.silh[self.it])
        self.it += 1
        for k, v in new.items():
            if v is not self.state[k]:
                self.state[k].copy_(v)
        return loss, aux

    def close(self):
        return self.state
