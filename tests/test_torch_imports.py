"""The port imports neither JAX nor the JAX package, and loads h5py, imageio
and PIL only where a function needs them. A fresh interpreter (with
JAX_PLATFORMS unset) imports every module of `drt_tpu_torch`, found by
walking the package, and `chip_smoke` as a module without running it; the
test then reads its `sys.modules`. The GPU machines the port runs on have no
JAX, so a stray import would otherwise show only there."""

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
                 "drt_tpu_torch.optimize.loop"):
        assert name in mods
    assert not any(m.startswith(f) for m in got["before"]
                   for f in ("jax", "drt_tpu"))
    loaded = [m for m in got["after"] if m.split(".")[0] in FORBIDDEN]
    assert loaded == [], loaded
