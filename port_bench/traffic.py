"""The one generator of every traffic mix: it reads a mix's parameters
from traffic/<name>.json and gives the view indices of each iteration, as
the reconstruction's `optimize` draws them (the reference's
captured_data.py:61-82): per iteration `ray_views` ray-loss views from a
shuffled stream over every view (reshuffled each epoch, seeded by the
run's seed plus `ray_seed_offset`) and `silh_views` silhouette views from
another (seed plus `silh_seed_offset`)."""

from __future__ import annotations

import json
import os

import numpy as np

TRAFFIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "traffic")


def load(name: str, traffic_dir: str = TRAFFIC_DIR) -> dict:
    with open(os.path.join(traffic_dir, f"{name}.json")) as fh:
        mix = json.load(fh)
    mix["name"] = name
    return mix


def _stream(num_views: int, seed: int):
    index = list(range(num_views))
    rng = np.random.default_rng(seed)
    while True:
        rng.shuffle(index)
        yield from index


def view_rows(mix: dict, num_views: int, seed: int, rows: int):
    """(ray rows [rows][ray_views], silhouette rows [rows][silh_views]) of
    Python ints."""
    ray = _stream(num_views, seed + mix["ray_seed_offset"])
    silh = _stream(num_views, seed + mix["silh_seed_offset"])
    return ([[next(ray) for _ in range(mix["ray_views"])]
             for _ in range(rows)],
            [[next(silh) for _ in range(mix["silh_views"])]
             for _ in range(rows)])
