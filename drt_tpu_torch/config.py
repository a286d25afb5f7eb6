"""Configuration (port of drt_tpu/config.py).

An immutable dataclass threaded explicitly through every call; no global
state. Default values mirror the reference exactly (config.py:18-40).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HyperParams:
    """Optimization hyper-parameters (reference: config.py:18-40)."""

    name: str = "pig"
    ior: float = 1.4723          # interior index of refraction (config.py:22)
    ext_ior: float = 1.00029     # air (DiffRender.py:21)
    num_passes: int = 20         # 'Pass' (config.py:23)
    iters: int = 200             # per-pass iterations (config.py:24)

    # loss weights (config.py:27-30)
    ray_w: float = 40.0
    sm_w: float = 0.08
    vh_w: float = 2e-3

    # optimizer (config.py:33-38)
    momentum: float = 0.95
    start_lr: float = 0.1
    lr_decay: float = 0.5
    lr_schedule: str = "reciprocal"  # reciprocal (reference parity,
                                 # optim.py:147-153) | len: lr tracks the
                                 # remesh edge length (start_lr at start_len,
                                 # proportional thereafter). 'len' suits
                                 # uadam, whose unit-normalized step is an
                                 # absolute displacement in mesh units and
                                 # must shrink with the feature scale
    start_len: float = 10.0      # remesh target edge length schedule start
    end_len: float = 1.0
    num_view: int = 72           # views used for the refraction loss

    # --- knobs with no reference equivalent ---
    optimizer: str = "sgd"       # sgd (reference parity) | adam | uadam
    precond: str = "none"        # none (reference parity) | sobolev | h1:
                                 # Laplacian-preconditioned vertex updates
                                 # (optimize/precondition.py)
    precond_lambda: float = 29.0  # Sobolev weight (I + lam*L)
    cg_iters: int = 64           # CG iterations for the Sobolev solve
    grad_clamp: float = 1.0      # reference limit_hook clamp (sgd+none, h1)
    ray_views_per_iter: int = 1  # refraction views averaged per step; >1
                                 # tames gradient noise at low capture res
    bilinear_mask: bool = False  # bilinear soft-mask sampling in the
                                 # silhouette loss (reference truncates)
    huber: float = 0.0           # Huber delta on per-ray direction
                                 # residuals; 0 = reference-parity L2
                                 # (see optimize/losses.ray_loss)
    dtype: str = "float32"       # compute dtype for the differentiable path
    backend: str = "auto"        # intersect backend: auto|brute|culled|cuda
    silhouette_budget: Optional[int] = None  # static silhouette-edge budget
    ray_chunk: int = 8192        # brute-force ray blocking
    tri_chunk: int = 512         # brute-force triangle blocking
    diff_ray_chunk: int = -1     # ray chunking of the differentiable
                                 # fwd+bwd trace (render/chunked.py):
                                 # -1 = auto (chunk only batches above a
                                 # full 1920x1080 view), 0 = never chunk
    seed: int = 0
    checkpoint_every_pass: bool = True
    no_coarsen: bool = False     # back-compat alias for
                                 # coarsen_policy="clamp"
    coarsen_policy: str = "schedule"
                                 # What to do while the LOD schedule's target
                                 # edge length is COARSER than the init
                                 # mesh's own mean edge length (a space-
                                 # carved init carries finer detail than a
                                 # crude hull; the early coarse passes can
                                 # destroy more accuracy than optimization
                                 # recovers at low capture resolution):
                                 #   "schedule": reference parity, always
                                 #     remesh at the scheduled target
                                 #   "clamp": remesh, but never above the
                                 #     init's mean edge length
                                 #   "skip": do not remesh at all until the
                                 #     scheduled target drops below the
                                 #     init's mean edge length (keeps the
                                 #     init topology bit-exact through the
                                 #     early passes)
                                 #   "auto": "skip" below 480 capture rows,
                                 #     "schedule" at or above
                                 # Default stays "schedule" (reference
                                 # parity).

    def replace(self, **kw) -> "HyperParams":
        return dataclasses.replace(self, **kw)


# Object -> camera rig assignment (reference: optim.py:133-134)
REDMI_OBJECTS = ("tiger", "pig", "horse", "rabbit")
POINTGRAY_OBJECTS = ("hand", "mouse", "dog", "monkey")

# Capture resolutions (reference: captured_data.py:90-91, 131-132)
POINTGRAY_RES = (960, 1280)   # (resy, resx)
REDMI_RES = (1080, 1920)

# The reference checkout's data directory ({name}_scan.ply ground truths,
# {name}_vh.ply hulls). The JAX package's DEFAULT_DATA_PATH fixes it under
# the root user's home; the port looks under the home of whoever runs it,
# which is the same directory for root. Only the CLI reads it (a synthetic
# capture without --gt-mesh, --init upstream, and the closing Hausdorff
# evaluation where the scan exists).
DEFAULT_DATA_PATH = os.path.join(os.path.expanduser("~"), "reference", "data",
                                 "")
