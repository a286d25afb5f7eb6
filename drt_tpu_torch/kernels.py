"""Build, bind and count the port's hand-written CUDA kernels.

Every csrc/*.cu is compiled with nvcc at first use (one object per source,
all started together) and linked into one shared library under build/
beside the package, bound through ctypes (a plain C interface builds in
seconds). Each source exports `<name>_launch`, which launches on a given
stream and returns cudaGetLastError(), and `<name>_signature()`, the names
of its arguments: `bind` types every entry point (`_ENTRIES`) and checks
each signature against `_SIGNATURES`, so a source and its wrapper cannot
drift apart unnoticed.

The wrappers:
- intersect/cuda_kernel.py: csrc/pack.cu, csrc/candidates.cu and
  csrc/closest_hit.cu, the three kernels of an oracle query, and
  csrc/order.cu, which a one-origin query launches before them;
- geometry/scatter.py: csrc/scatter.cu, the row scatter-add;
- optimize/precondition.py: csrc/cg.cu, the Sobolev preconditioner's
  conjugate-gradient solve;
- render/bounce.py: csrc/bounce.cu, a bounce's per-lane chain after its
  oracle query and the ray loss's per-lane tail, forward and backward;
- render/silhouette_kernels.py: csrc/silhouette.cu, a silhouette view's
  chain before and after its oracle query and its backward;
- spans.py: csrc/span.cu, the train step's device span markers.

`counters` counts each kernel's launches; a wrapper adds one only where it
launches its kernel (never on the plain version's path). Sources share
code through csrc/*.cuh headers, which a rebuild watches as well. A CUDA graph's
replay adds the launches its capture recorded (optimize/loop.py
`GraphedTrainStep`). The span markers are counted nowhere.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "drt_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class LaunchCounter:
    """Counts oracle queries (`calls`, of which `one_origin_queries` took the
    one-origin route, on either device; each launches csrc/order.cu once on
    the card) and the launches of the closest-hit kernel (`launches`), of
    the candidate-prepass kernel (`candidates_launches`) and of the packing
    kernel (`pack_launches`), each one a query of either kind, and of the
    row scatter-add
    (`scatter_launches`, one a `scatter_rows` call on CUDA tensors, of
    which `scatter_cluster_launches` took the cluster route and
    `scatter_grid_launches` the grid route), and of the conjugate-gradient
    solve (`cg_launches`, one a solve on CUDA tensors, of which
    `cg_shared_launches` took the shared route and `cg_global_launches` the
    global route, and `cg_adjoint_launches` were the adjoint solves of
    `sobolev_solve`'s backward), and of csrc/bounce.cu: a bounce's chain
    (`bounce_launches`, forward and backward, of which
    `bounce_backward_launches` backward) and the ray loss's tail
    (`ray_tail_launches`, of which `ray_tail_backward_launches`
    backward), and of csrc/silhouette.cu: a silhouette view's chain before
    its oracle query (`silhouette_pre_launches`), after it
    (`silhouette_post_launches`) and its backward
    (`silhouette_backward_launches`), one each a view."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls = 0
        self.launches = 0
        self.candidates_launches = 0
        self.pack_launches = 0
        self.one_origin_queries = 0
        self.scatter_launches = 0
        self.scatter_cluster_launches = 0
        self.scatter_grid_launches = 0
        self.cg_launches = 0
        self.cg_shared_launches = 0
        self.cg_global_launches = 0
        self.cg_adjoint_launches = 0
        self.bounce_launches = 0
        self.bounce_backward_launches = 0
        self.ray_tail_launches = 0
        self.ray_tail_backward_launches = 0
        self.silhouette_pre_launches = 0
        self.silhouette_post_launches = 0
        self.silhouette_backward_launches = 0

    def snapshot(self) -> dict:
        """Every count, by name."""
        return dict(vars(self))

    def add(self, delta: dict, times: int = 1):
        """Add `times` x `delta` (counts by name) to the counts: a CUDA
        graph's replay adds the launches its capture recorded, and the
        capture, which launched nothing, takes its own back."""
        for name, n in delta.items():
            setattr(self, name, getattr(self, name) + times * n)


counters = LaunchCounter()
_lib_lock = threading.Lock()
_lib = None
build_log = ""


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the kernels are built from "
                           "csrc/*.cu at first use")
    return path


def build(force: bool = False, defines: tuple = ()) -> str:
    """Compile every csrc/*.cu (one nvcc each, all started together) and
    link the objects into one shared library, if it is missing or older
    than any source; return its path. `build_log` keeps what ptxas said.
    `defines` ("NAME=value", ...) go to nvcc as -D and make a library of
    their own (scripts/tune_torch_oracle.py builds such variants)."""
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    suffix = "".join("_" + d.replace("=", "") for d in defines)
    out = os.path.join(BUILD_DIR, f"libdrt_kernels{suffix}.so")
    sources = sorted(glob.glob(os.path.join(_SOURCE_DIR, "*.cu")))
    if not sources:
        raise RuntimeError(f"no kernel sources in {_SOURCE_DIR}")
    headers = glob.glob(os.path.join(_SOURCE_DIR, "*.cuh"))
    if (not force and os.path.exists(out) and os.path.getmtime(out)
            >= max(os.path.getmtime(s) for s in sources + headers)):
        return out
    nvcc, tag = _nvcc(), f"{os.getpid()}{suffix}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in sources]
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", o, s],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    try:
        for s, p in zip(sources, procs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n"
                                   f"{build_log}")
        tmp = f"{out}.{tag}.tmp"
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, out)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return out


_VP, _CI, _CF, _CD, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                           ctypes.c_double, ctypes.c_longlong)
# The C interface of every source: name -> (argument types, result type).
_ENTRIES = {
    # closest_hit.cu
    "closest_hit_launch": ([_VP] * 8 + [_CI] * 6 + [_CF] + [_VP] * 3, _CI),
    "closest_hit_tri_chunk": ([], _CI),
    "closest_hit_max_ray_tile": ([], _CI),
    # candidates.cu
    "candidates_launch": ([_VP] * 5 + [_CI] * 4 + [_CF] + [_VP] * 3, _CI),
    "candidates_max_ray_tile": ([], _CI),
    "candidates_max_chunks": ([], _CI),
    "candidates_block": ([], _CI),
    # pack.cu
    "pack_launch": ([_VP, _CI, _VP, _CI, _VP, _CI, _VP, _VP, _CI, _CI, _VP,
                     _CI, _VP] + [_CI] * 5 + [_VP] * 9, _CI),
    "pack_tri_chunk": ([], _CI),
    "pack_n_coef": ([], _CI),
    # order.cu
    "ray_order_launch": ([_VP, _CI, _CI, _CI] + [_VP] * 3, _CI),
    "ray_order_scratch_ints": ([_LL], _LL),
    "ray_order_axis_bits": ([], _CI),
    # scatter.cu
    "scatter_launch": ([_VP, _CI, _VP, _CI, _CI, _CI, _CI, _VP, _VP, _VP],
                       _CI),
    "scatter_scratch_ints": ([_LL, _LL, _CI], _LL),
    "scatter_max_cols": ([], _CI),
    "scatter_cluster_size": ([], _CI),
    # cg.cu
    "cg_launch": ([_VP, _VP, _CI, _VP, _VP, _CI, _CI, _CI, _CD, _CD, _CI]
                  + [_VP] * 4, _CI),
    "cg_scratch_bytes": ([_LL, _CI, _CI, _CI], _LL),
    "cg_ctas": ([], _CI),
    "cg_block": ([], _CI),
    "cg_cluster_ready": ([], _CI),
    "cg_shared_launch": ([_VP, _VP, _CI, _VP, _VP, _CI, _CI, _CI, _CD, _CD,
                          _CI] + [_VP] * 4, _CI),
    "cg_shared_bytes": ([_LL, _CI, _CI, _CI], _LL),
    "cg_shared_scratch_bytes": ([_LL, _CI], _LL),
    "cg_shared_budget": ([], _CI),
    # bounce.cu
    "bounce_launch": ([_VP] * 7 + [_LL, _CI, _CD, _CD, _CD, _CI]
                      + [_VP] * 5, _CI),
    "bounce_backward_launch": ([_VP] * 6 + [_LL, _CI, _CD, _CD, _CD, _CI]
                               + [_VP] * 4, _CI),
    "ray_tail_launch": ([_VP] * 6 + [_LL, _CI, _CD] + [_VP] * 4, _CI),
    "ray_tail_backward_launch": ([_VP] * 6 + [_LL, _CI, _CD] + [_VP] * 3,
                                 _CI),
    "bounce_block": ([], _CI),
    "ray_tail_block": ([], _CI),
    "ray_tail_blocks": ([], _CI),
    # silhouette.cu
    "silhouette_pre_launch": ([_VP, _CI, _VP, _CI, _VP, _VP, _VP, _CI]
                              + [_VP] * 5 + [_LL, _VP, _CI] + [_VP] * 9,
                              _CI),
    "silhouette_post_launch": ([_VP, _VP, _VP, _VP, _CI, _LL, _LL, _VP]
                               + [_CI] * 4 + [_VP] * 3, _CI),
    "silhouette_backward_launch": ([_VP] * 5 + [_CI, _VP, _VP, _CI, _VP,
                                                 _VP], _CI),
    "silhouette_block": ([], _CI),
    "silhouette_sum_blocks": ([], _CI),
    "silhouette_bwd_block": ([], _CI),
    "silhouette_cluster_size": ([], _CI),
    "silhouette_pre_smem": ([_LL, _LL, _CI], _LL),
    "silhouette_pre_smem_cap": ([], _LL),
    # span.cu
    "span_mark_launch": ([_CI, _VP, ctypes.POINTER(_VP)], _CI),
    "span_nodes_set_enabled": ([_VP, ctypes.POINTER(_VP), _CI, _CI], _CI),
    # errors.cu
    "drt_error_string": ([_CI], ctypes.c_char_p),
}

# The argument lists the wrappers pass, as each source's *_signature()
# names them.
_SIGNATURES = {
    "closest_hit_signature": "phi inv coef lo hi cand count order n_tiles "
                             "ray_tile block_rays ray_lanes n_groups group "
                             "t_min t_out id_out stream",
    "candidates_signature": "org inv lo hi valid n_tiles ray_tile nc "
                            "tile_mode t_min cand count stream",
    "pack_signature": "vertices vert_f64 faces faces_i64 face_valid n_faces "
                      "shift origins org_f64 org_stride dirs dir_f64 order "
                      "n_rays n_groups group n_tiles ray_tile coef lo hi "
                      "box_lo box_hi box_valid phi inv stream",
    "ray_order_signature": "dirs dir_f64 n_rays np order scratch stream",
    "scatter_signature": "rows rows_f64 idx n_rows n_cols n_out route out "
                         "scratch stream",
    "cg_signature": "b x0 f64 nbr valid vp c d lam tol2 maxiter x trips "
                    "scratch stream",
    "cg_shared_signature": "b x0 f64 nbr valid vp c d lam tol2 maxiter x "
                           "trips scratch stream",
    "bounce_signature": "org dir g9 hit active safe_id park_o n f64 int_ior "
                        "ext_ior offset_eps compat o_out d_out act_out "
                        "tri_out stream",
    "bounce_backward_signature": "org dir g9 alive go gd n f64 int_ior "
                                 "ext_ior offset_eps compat d_org d_dir dg9 "
                                 "stream",
    "ray_tail_signature": "org dir sp lane_valid active exit_hit n f64 huber "
                          "loss partials counter stream",
    "ray_tail_backward_signature": "org dir sp lane_valid active exit_hit n "
                                   "f64 huber g d_dir stream",
    "silhouette_pre_signature": "verts f64 faces n_faces edge_faces "
                                "edge_valid edges n_edges R K R_inv K_inv "
                                "org org_stride view budget edge_idx count "
                                "org_out ray_dir sample normal pix vidx "
                                "stream",
    "silhouette_post_signature": "tri_id sample count mask f64 mask_stride "
                                 "mask_row view resy resx bilinear budget "
                                 "loss coef stream",
    "silhouette_backward_signature": "normal coef pix R K f64 view g budget "
                                     "dV stream",
    "span_signature": "kind stream node",
    # the markers' kinds, in the order of the `kind` argument (spans.py)
    "span_kinds_signature": "step normals ray silhouette smooth backward "
                            "update solve end",
}


def bind(path: str):
    """The library at `path` (from `build`) with every entry point typed and
    every signature checked."""
    lib = ctypes.CDLL(path)
    for name, (args, res) in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    for name, want in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], ctypes.c_char_p
        if fn().decode() != want:
            raise RuntimeError(f"csrc: {name}() is {fn().decode()!r}, "
                               f"the wrapper passes {want!r}")
    return lib


def load():
    """The bound library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build())
    return _lib


def check(lib, err: int, what: str):
    """Raise if a `*_launch` returned a CUDA error."""
    if err != 0:
        msg = lib.drt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")
