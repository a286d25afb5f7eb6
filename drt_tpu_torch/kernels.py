"""Build, bind, launch and count the port's hand-written CUDA kernels.

Every csrc/*.cu is compiled with nvcc at first use (one object per source,
all started together) and linked into one shared library under build/
beside the package, bound through ctypes (a plain C interface builds in
seconds). Each source exports `<name>_launch`, which launches on a given
stream and returns cudaGetLastError(), and `<name>_signature()`, the names
of its arguments. `LAUNCHES` gives each launch one row, its arguments'
names and C types together; `bind` types every entry point from the rows
and `_ENTRIES` and checks each row's names against the source's signature,
so a source and its wrapper cannot drift apart unnoticed.

The layer every wrapper launches through:
- `launch(name, like, counts, **args)`: the arguments by their signature
  names (a tensor passes its pointer, None NULL, a bool an int; `stream` is
  `like`'s device's current stream), the CUDA error checked, the named
  counters counted;
- `expect(what, t, shape, dtype, device)`: one tensor's shape, dtype,
  device and contiguity, and `need_cuda`;
- `on_device(t, cuda, plain)`: the kernel's wrapper on a CUDA tensor, the
  plain version on a CPU tensor, any other device refused;
- `checks(*names)`: a module's check of the library (launch shapes that
  fix a summation order, constants, the card's readiness), which `library`
  runs once per bound library before the module's first launch.

The sources and their wrappers:
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
- spans.py: csrc/span.cu, the train step's device span markers;
- csrc/errors.cu: the CUDA error's text.

`counters` counts each kernel's launches; a wrapper adds one only where it
launches its kernel (never on the plain version's path). Sources share
code through csrc/*.cuh headers, which a rebuild watches as well. A CUDA
graph's replay adds the launches its capture recorded (optimize/loop.py
`GraphedTrainStep`). The span markers are counted nowhere.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "drt_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class LaunchCounter:
    """Counts by name: oracle queries on either device (`calls`, of which
    `one_origin_queries` took the one-origin route, each launching
    csrc/order.cu once on the card), and the kernels' launches: the closest
    hit's (`launches`), the candidate prepass's and the packing kernel's,
    one each a query (the prepass's ray-mode launches, which cull each
    tile's boxes by its frustum, also in `prepass_cull_launches`); the row
    scatter-add's (one a `scatter_rows` call, by route in
    `scatter_cluster_launches` and `scatter_grid_launches`); the
    CG solve's (one a solve, by route in `cg_shared_launches` and
    `cg_global_launches`, the adjoint solves of `sobolev_solve`'s backward
    in `cg_adjoint_launches`); csrc/bounce.cu's, a bounce's chain
    (`bounce_launches`) and the ray loss's tail (`ray_tail_launches`),
    forward and backward, the backward ones also in `*_backward_launches`;
    and csrc/silhouette.cu's, one each a view."""

    NAMES = ("calls launches candidates_launches pack_launches "
             "one_origin_queries scatter_launches scatter_cluster_launches "
             "scatter_grid_launches cg_launches cg_shared_launches "
             "cg_global_launches cg_adjoint_launches bounce_launches "
             "bounce_backward_launches ray_tail_launches "
             "ray_tail_backward_launches silhouette_pre_launches "
             "silhouette_post_launches silhouette_backward_launches "
             "prepass_cull_launches").split()

    def __init__(self):
        self.reset()

    def reset(self):
        for name in self.NAMES:
            setattr(self, name, 0)

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


# ctypes types by code: p pointer, pp pointer to a pointer (an
# out-parameter), i int, l long long, f float, d double, s C string.
_CTYPES = {"p": ctypes.c_void_p, "pp": ctypes.POINTER(ctypes.c_void_p),
           "i": ctypes.c_int, "l": ctypes.c_longlong, "f": ctypes.c_float,
           "d": ctypes.c_double, "s": ctypes.c_char_p}

# Every `<name>_launch`, one row each: its arguments as `name:type`, the
# names in the order of the source's `<name>_signature()` (`bind` checks
# them), the types by `_CTYPES`. A launch returns its cudaError_t.
LAUNCHES = {
    # closest_hit.cu
    "closest_hit": "phi:p inv:p coef:p lo:p hi:p cand:p count:p order:p "
                   "n_tiles:i ray_tile:i block_rays:i ray_lanes:i "
                   "n_groups:i group:i t_min:f t_out:p id_out:p stream:p",
    # candidates.cu
    "candidates": "org:p inv:p lo:p hi:p valid:p n_tiles:i ray_tile:i nc:i "
                  "tile_mode:i t_min:f cand:p count:p kept:p stream:p",
    # pack.cu
    "pack": "vertices:p vert_f64:i faces:p faces_i64:i face_valid:p "
            "n_faces:i shift:p origins:p org_f64:i org_stride:i dirs:p "
            "dir_f64:i order:p n_rays:i n_groups:i group:i n_tiles:i "
            "ray_tile:i coef:p lo:p hi:p box_lo:p box_hi:p box_valid:p "
            "phi:p inv:p stream:p",
    # order.cu
    "ray_order": "dirs:p dir_f64:i n_rays:i np:i order:p scratch:p stream:p",
    # scatter.cu
    "scatter": "rows:p rows_f64:i idx:p n_rows:i n_cols:i n_out:i route:i "
               "out:p scratch:p stream:p",
    # cg.cu: the two routes take the same arguments
    "cg": "b:p x0:p f64:i nbr:p valid:p vp:i c:i d:i lam:d tol2:d "
          "maxiter:i x:p trips:p scratch:p stream:p",
    "cg_shared": "b:p x0:p f64:i nbr:p valid:p vp:i c:i d:i lam:d tol2:d "
                 "maxiter:i x:p trips:p scratch:p stream:p",
    # bounce.cu
    "bounce": "org:p dir:p g9:p hit:p active:p safe_id:p park_o:p n:l "
              "f64:i int_ior:d ext_ior:d offset_eps:d compat:i o_out:p "
              "d_out:p act_out:p tri_out:p stream:p",
    "bounce_backward": "org:p dir:p g9:p alive:p go:p gd:p n:l f64:i "
                       "int_ior:d ext_ior:d offset_eps:d compat:i d_org:p "
                       "d_dir:p dg9:p stream:p",
    "ray_tail": "org:p dir:p sp:p lane_valid:p active:p exit_hit:p n:l "
                "f64:i huber:d loss:p partials:p counter:p stream:p",
    "ray_tail_backward": "org:p dir:p sp:p lane_valid:p active:p "
                         "exit_hit:p n:l f64:i huber:d g:p d_dir:p stream:p",
    # silhouette.cu
    "silhouette_pre": "verts:p f64:i faces:p n_faces:i edge_faces:p "
                      "edge_valid:p edges:p n_edges:i R:p K:p R_inv:p "
                      "K_inv:p org:p org_stride:l view:p budget:i "
                      "edge_idx:p count:p org_out:p ray_dir:p sample:p "
                      "normal:p pix:p vidx:p stream:p",
    "silhouette_post": "tri_id:p sample:p count:p mask:p f64:i "
                       "mask_stride:l mask_row:l view:p resy:i resx:i "
                       "bilinear:i budget:i loss:p coef:p stream:p",
    "silhouette_backward": "normal:p coef:p pix:p R:p K:p f64:i view:p g:p "
                           "budget:i dV:p stream:p",
    # span.cu: `node` takes a ctypes.byref, the marker's graph node
    "span_mark": "kind:i stream:p node:pp",
}
# A launch whose signature function is not `<name>_signature`.
_SIGNATURE_OF = {"span_mark": "span_signature"}
# span.cu's marker kinds, in the order of the `kind` argument (spans.py).
SPAN_KINDS = "step normals ray silhouette smooth backward update solve end"


def _row(text: str) -> tuple:
    """((argument names), (ctypes types)) of a row: a word without one
    type of _CTYPES fails at import."""
    pairs = [word.split(":") for word in text.split()]
    return tuple(n for n, _ in pairs), tuple(_CTYPES[c] for _, c in pairs)


ROWS = {name: _row(text) for name, text in LAUNCHES.items()}

# The other entry points: the sources' constants and scratch sizes, the
# span nodes' switch and the error string, each "argument types:result type"
# by the codes of _CTYPES (s a C string).
_ENTRIES = {
    "closest_hit_tri_chunk": ":i", "closest_hit_max_ray_tile": ":i",
    "candidates_max_ray_tile": ":i", "candidates_max_chunks": ":i",
    "candidates_block": ":i", "pack_tri_chunk": ":i", "pack_n_coef": ":i",
    "ray_order_scratch_ints": "l:l", "ray_order_axis_bits": ":i",
    "scatter_scratch_ints": "l l i:l", "scatter_max_cols": ":i",
    "scatter_cluster_size": ":i", "cg_scratch_bytes": "l i i i:l",
    "cg_ctas": ":i", "cg_block": ":i", "cg_cluster_ready": ":i",
    "cg_shared_bytes": "l i i i:l", "cg_shared_scratch_bytes": "l i:l",
    "cg_shared_budget": ":i", "bounce_block": ":i", "ray_tail_block": ":i",
    "ray_tail_blocks": ":i", "silhouette_block": ":i",
    "silhouette_sum_blocks": ":i", "silhouette_bwd_block": ":i",
    "silhouette_cluster_size": ":i", "silhouette_pre_smem": "l l i:l",
    "silhouette_pre_smem_cap": ":l", "span_nodes_set_enabled": "p pp i i:i",
    "drt_error_string": "i:s",
}


def signatures() -> dict:
    """What each `*_signature()` of the sources returns: a launch's row's
    names, and span.cu's marker kinds."""
    out = {_SIGNATURE_OF.get(name, f"{name}_signature"): " ".join(names)
           for name, (names, _) in ROWS.items()}
    out["span_kinds_signature"] = SPAN_KINDS
    return out


def bind(path: str):
    """The library at `path` (from `build`) with every entry point typed and
    every launch's row checked against its source's signature."""
    lib = ctypes.CDLL(path)
    for name, types in _ENTRIES.items():
        args, _, res = types.partition(":")
        fn = getattr(lib, name)
        fn.argtypes = [_CTYPES[c] for c in args.split()]
        fn.restype = _CTYPES[res]
    for name, (_, types) in ROWS.items():
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes, fn.restype = list(types), ctypes.c_int
    for name, want in signatures().items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], ctypes.c_char_p
        if fn().decode() != want:
            raise RuntimeError(f"csrc: {name}() is {fn().decode()!r}, the "
                               f"wrapper passes {want!r}")
    return lib


def load():
    """The bound library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build())
    return _lib


# The library checks of the wrapper modules: launch name -> its module's
# check, and check -> the library it last passed.
_CHECKS = {}
_checked = {}


def checks(*names: str):
    """Decorator: `fn(lib)` checks a bound library for the launches `names`
    (their launch shapes, constants, the card's readiness) and raises if it
    does not serve them; `library` runs it once per bound library, before
    the first of those launches."""
    unknown = [n for n in names if n not in LAUNCHES]
    if unknown:
        raise ValueError(f"kernels.checks: no launch {unknown}")

    def register(fn):
        for name in names:
            _CHECKS[name] = fn
        return fn
    return register


def library(name: str):
    """The bound library (built at first use), checked for launch `name`
    by its module's registered check."""
    lib = load()
    fn = _CHECKS.get(name)
    if fn is not None and _checked.get(fn) is not lib:
        fn(lib)
        _checked[fn] = lib
    return lib


def check(lib, err: int, what: str):
    """Raise if a `*_launch` returned a CUDA error."""
    if err != 0:
        msg = lib.drt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def launch(name: str, like, counts=(), what: str = None, **args):
    """Launch `<name>_launch` with `args` by the names of its row, but for
    `stream`, the current stream of `like` (a tensor's device, or a
    device): a tensor passes its data pointer, None NULL, a bool an int
    (as ctypes takes it). Raises if the call's names are not the row's, or
    if the launch returns a CUDA error (`what`, by default the name with
    spaces, names it); then adds one to each counter of `counts`."""
    names = ROWS[name][0]
    want = set(names) - {"stream"}
    if set(args) != want:
        raise TypeError(f"{name}_launch: missing {sorted(want - set(args))}, "
                        f"unknown {sorted(set(args) - want)}")
    lib = library(name)
    fn = getattr(lib, f"{name}_launch")
    device = getattr(like, "device", like)
    with torch.cuda.device(device):
        args["stream"] = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in map(args.get, names)))
    check(lib, err, what or name.replace("_", " "))
    for c in counts:
        setattr(counters, c, getattr(counters, c) + 1)


# The float types the kernels take.
FLOATS = (torch.float32, torch.float64)


def expect(what: str, t, shape, dtype, device):
    """Raise ValueError unless tensor `t` (named `what`) has `shape` (None
    in a place: any size), `dtype` (or one of a tuple of them), lies on
    `device` and is contiguous. A `t` of None passes (an optional
    argument)."""
    if t is None:
        return
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if (t.dim() != len(shape) or t.dtype not in dtypes
            or any(w not in (None, g) for g, w in zip(t.shape, shape))):
        kinds = " or ".join(str(d)[6:] for d in dtypes)   # less "torch."
        raise ValueError(f"{what}: expected {list(shape)} {kinds}, got "
                         f"{list(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def need_cuda(what: str, t):
    """Raise ValueError unless `t` lies on a CUDA device: a kernel's wrapper
    launches its kernel or refuses, never running elsewhere."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors")


def on_device(t, cuda, plain):
    """The kernel's wrapper `cuda` for a CUDA tensor `t`, the plain version
    `plain` for a CPU tensor; any other device raises."""
    if t.device.type == "cuda":
        return cuda
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"unsupported device {t.device}")
