"""The port imports neither JAX nor the JAX package, and loads h5py, imageio
and PIL only where a function needs them. A fresh interpreter (with
JAX_PLATFORMS unset) imports every module of `drt_tpu_torch`, found by
walking the package, and `chip_smoke` as a module without running it; the
test then reads its `sys.modules`. The GPU machines the port runs on have no
JAX, so a stray import would otherwise show only there. A second test lists,
module by module, the public names of drt_tpu that the port lacks, and a
third, function by function, the parameters it lacks."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
before = set(sys.modules)
import drt_tpu_torch
names = ["drt_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    drt_tpu_torch.__path__, "drt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
print(json.dumps({"modules": names, "before": sorted(before),
                  "after": sorted(sys.modules),
                  "has_main": callable(getattr(smoke, "main", None))}))
"""

FORBIDDEN = ("jax", "jaxlib", "drt_tpu", "h5py", "imageio", "PIL")


def test_port_imports_no_jax_and_no_optional_packages():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", PROBE,
                          os.path.join(REPO, "chip_smoke.py")],
                         env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["has_main"]
    mods = set(got["modules"])
    for name in ("drt_tpu_torch.cli", "drt_tpu_torch.data.carve",
                 "drt_tpu_torch.data.captured", "drt_tpu_torch.utils.images",
                 "drt_tpu_torch.intersect.cuda_kernel",
                 "drt_tpu_torch.optimize.loop",
                 "drt_tpu_torch.parallel.sharding",
                 "drt_tpu_torch.parallel.multihost",
                 "drt_tpu_torch.geometry.laplacian"):
        assert name in mods
    assert not any(m.startswith(f) for m in got["before"]
                   for f in ("jax", "drt_tpu"))
    loaded = [m for m in got["after"] if m.split(".")[0] in FORBIDDEN]
    assert loaded == [], loaded


def _public_names(path, package):
    """{name: defining module} of the public top-level names of a source
    file: its functions, classes and assignments, and for an __init__.py
    the names it imports (re-exports), credited to the module they come
    from."""
    import ast
    mod = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
    init = mod.endswith(".__init__")
    mod = mod[:-len(".__init__")] if init else mod
    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = mod
        elif isinstance(node, ast.Assign):
            out.update({t.id: mod for t in node.targets
                        if isinstance(t, ast.Name)})
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out[node.target.id] = mod
        elif init and isinstance(node, ast.ImportFrom) and \
                (node.module or "").startswith(package):
            out.update({a.asname or a.name: node.module for a in node.names})
    return {k: v for k, v in out.items() if not k.startswith("_")}


def test_port_has_every_public_name_of_the_jax_package():
    """Module by module, the public top-level names of drt_tpu that the
    module of the same path in drt_tpu_torch lacks are exactly the named
    exceptions: utils/cache.py (there is no XLA cache to point), the Pallas
    kernel's module (its counterpart is intersect/cuda_kernel.py) and
    render/silhouette.py's make_edge_sampler (an autograd.Function in the
    port)."""
    import importlib
    jax_root = os.path.join(REPO, "drt_tpu")
    lacking = {}                      # defining module -> names lacked
    for dirpath, _, files in os.walk(jax_root):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            names = _public_names(path, "drt_tpu")
            rel = os.path.relpath(path, jax_root)[:-3].replace(os.sep, ".")
            port = "drt_tpu_torch" + ("." + rel).replace(".__init__", "")
            if os.path.exists(os.path.join(REPO, "drt_tpu_torch",
                                           os.path.relpath(path, jax_root))):
                have = vars(importlib.import_module(port))
            else:
                have = {}
            for name, origin in names.items():
                if name not in have:
                    lacking.setdefault(origin, set()).add(name)

    def all_of(module):
        path = os.path.join(REPO, *module.split(".")) + ".py"
        return set(_public_names(path, "drt_tpu"))

    assert lacking == {
        "drt_tpu.utils.cache": all_of("drt_tpu.utils.cache"),
        "drt_tpu.intersect.pallas_kernel": all_of(
            "drt_tpu.intersect.pallas_kernel"),
        "drt_tpu.render.silhouette": {"make_edge_sampler"},
    }


# Parameters of drt_tpu's public functions that the port's counterpart does
# not take, each with its reason: {(module, function): {parameter: reason}}.
PARAMETERS_LEFT_OUT = {
    **{(m, f): {"ray_shard_count": "the port gathers the triangles of a "
                "ray's hit by one route; there are no gather shards to "
                "count"}
       for m, f in (("render.trace", "trace2"),
                    ("render.trace", "render_transparent"),
                    ("optimize.losses", "ray_loss"),
                    ("optimize.losses", "total_loss"),
                    ("optimize.loop", "make_train_step"))},
    ("parallel.sharding", "make_ray_mesh"): {
        "devices": "a torch.distributed process group takes the place of "
                   "JAX's device list"},
    ("intersect.pallas_kernel", "intersect_pallas"): {
        "ray_tile": "fixed by the kind of query (RAY_TILE_COHERENT, "
                    "RAY_TILE_INCOHERENT) and __launch_bounds__ in csrc/",
        "tri_chunk": "fixed at TRI_CHUNK = 128 in csrc/closest_hit.cu",
        "prepass": "follows `coherent`: the tile prepass for coherent "
                   "queries, the per-ray one for the others",
        "interpret": "no interpreter: CPU tensors take the plain versions"},
}
# A JAX function whose counterpart has another name or module.
COUNTERPART = {("intersect.pallas_kernel", "intersect_pallas"):
               ("intersect.cuda_kernel", "intersect_cuda")}


def _parameters(node):
    """The names a call can pass: every parameter, *args and **kwargs as
    '*' and '**'."""
    a = node.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + ["*"] * bool(a.vararg) + ["**"] * bool(a.kwarg)


def test_port_takes_every_parameter_of_the_jax_package():
    """For every public top-level function of drt_tpu (read from its
    source) whose counterpart the port has, the parameters the counterpart
    does not take (read from its signature) are exactly the named ones of
    PARAMETERS_LEFT_OUT."""
    import ast
    import importlib
    import inspect
    jax_root = os.path.join(REPO, "drt_tpu")
    kinds = {inspect.Parameter.VAR_POSITIONAL: "*",
             inspect.Parameter.VAR_KEYWORD: "**"}
    lacking, checked = {}, 0
    for dirpath, _, files in os.walk(jax_root):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, jax_root)[:-3].replace(os.sep, ".")
            for node in ast.parse(open(path).read()).body:
                if (not isinstance(node, ast.FunctionDef)
                        or node.name.startswith("_")):
                    continue
                mod, name = COUNTERPART.get((rel, node.name),
                                            (rel, node.name))
                port = "drt_tpu_torch" + ("." + mod).replace(".__init__", "")
                if not os.path.exists(os.path.join(
                        REPO, *port.split(".")) + ".py"):
                    continue
                fn = getattr(importlib.import_module(port), name, None)
                if fn is None:      # a lacking name: the test above's
                    continue
                have = {kinds.get(p.kind, p.name) for p in
                        inspect.signature(fn).parameters.values()}
                checked += 1
                missing = {p for p in _parameters(node) if p not in have}
                if missing:
                    lacking[(rel, node.name)] = missing
    assert checked > 90               # 98 functions when written
    assert lacking == {k: set(v) for k, v in PARAMETERS_LEFT_OUT.items()}
