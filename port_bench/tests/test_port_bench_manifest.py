"""BENCHMARK.json against the benchmark's contract, the harness's lookup
of every cell's files by name, and the refusals of run.py."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from port_bench import bench, tracing

ROOT = bench.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_manifest_keys_and_sizes(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "port_bench/run.py"]
    assert man["paths"] == ["port_bench"]
    assert 1 <= man["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (man["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_names_and_units(man):
    names = ([c["name"] for c in man["configs"]]
             + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in man["workloads"] + man["configs"]]
                 + [m["layer"] for m in man["per_layer"]]
                 + [c["source"] for c in man["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics_cover_every_cell(man):
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
    for c in cells:
        reported = [m for m in man["end_to_end"]
                    if c in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(c in m["workloads"] for m in man["per_layer"])


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits", "metrics"])
def test_every_cell_finds_its_files_by_name(man, kind):
    cfgs = {c["name"]: c for c in man["configs"]}
    for w in man["workloads"]:
        cell, cfg, mix, limits, layer = bench.resolve(w["name"], ROOT)
        if kind == "configs":
            entry = cfgs[w["config"]]
            assert entry["file"].startswith("port_bench/")
            assert cfg["name"] == w["config"]
            assert cfg["reduced"] == entry["reduced"]
        elif kind == "traffic":
            assert mix["name"] == w["traffic"]
        elif kind == "limits":
            assert limits and all(v > 0 for v in limits.values())
        else:
            for name in layer:
                assert callable(bench.metric_reader(name, ROOT))


def test_every_configuration_brings_its_reference(man):
    """Each configuration's reference module, reference/<its name>.py or
    else reference/step.py, provides the interface (reference/step.py's
    docstring); the first two take reference/step.py; loaded in a fresh
    interpreter, none loads anything of the program or of JAX."""
    ref_dir = os.path.join(ROOT, "port_bench", "reference")
    files = []
    for entry in man["configs"]:
        path = os.path.join(ROOT, entry["file"])
        cfg = bench.read_json(path)
        own = os.path.join(ref_dir, f"{cfg['name']}.py")
        want = own if os.path.isfile(own) else os.path.join(
            ref_dir, f"{bench.REFERENCE}.py")
        mod = bench.reference_of(cfg, ROOT)
        assert os.path.samefile(mod.__file__, want)
        assert all(callable(getattr(mod, k)) for k in bench.INTERFACE)
        if entry["name"] in ("dog-pointgray-parity", "dog-pointgray-adv"):
            assert os.path.basename(want) == "step.py"
        files.append(path)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from port_bench import bench\n"
            "for f in %r:\n"
            "    bench.reference_of(bench.read_json(f), %r)\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
            "             & {'drt_tpu_torch', 'drt_tpu', 'jax', 'jaxlib'})\n"
            "print(bad)" % (ROOT, files, ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_a_reference_short_of_the_interface_is_refused(tmp_path):
    ref = tmp_path / "port_bench" / "reference"
    ref.mkdir(parents=True)
    (ref / "short.py").write_text(
        "from port_bench.reference.step import precision, init_state  "
        "# noqa: F401\n")
    with pytest.raises(ValueError, match="lacks"):
        bench.reference_of({"name": "short"}, str(tmp_path))


def test_the_guard_sees_what_a_reference_loads(tmp_path):
    ref = tmp_path / "port_bench" / "reference"
    ref.mkdir(parents=True)
    (ref / "loads-jaxlib.py").write_text(
        "import sys\nimport types\n\n"
        "sys.modules.setdefault('jaxlib', types.ModuleType('jaxlib'))\n"
        "from port_bench.reference.step import *  # noqa: E402,F401,F403\n")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from port_bench import bench\n"
            "bench.reference_of({'name': 'loads-jaxlib'}, %r)\n"
            "print(bench.forbidden_modules())" % (ROOT, str(tmp_path)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "['jaxlib']"


def _trace(**kw):
    base = dict(device=[("void closest_hit_kernel<1>(int)", 0.0, 40.0),
                        ("Memset (Device)", 50.0, 60.0)],
                host=[("cudaGraphLaunch", 0.0, 5.0)], steps=2,
                window_s=100e-6, busy_s=50e-6,
                config={"rig": {"resy": 2, "resx": 2},
                        "silhouette_budget": 1},
                mix={"ray_views": 1, "silh_views": 8}, mesh=(4, 4),
                kernels=frozenset({"closest_hit_kernel"}))
    base.update(kw)
    return tracing.Trace(**base)


def test_a_dropped_in_metric_is_found_without_an_edit(tmp_path, man):
    root = tmp_path / "root"
    shutil.copytree(os.path.join(ROOT, "port_bench"), root / "port_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (root / "port_bench" / "metrics" / "memset_ms.py").write_text(
        "from port_bench.tracing import kernel_ms\n\n\n"
        "def read(trace):\n    return kernel_ms(trace, ('Memset',))\n")
    man = json.loads(json.dumps(man))
    cell = man["workloads"][0]["name"]
    man["per_layer"].append({"name": "memset_ms", "unit": "ms",
                             "better": "lower", "source": "device_trace",
                             "layer": "graph", "moves": "step_ms",
                             "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    layer = bench.resolve(cell, str(root))[4]
    assert "memset_ms" in layer
    assert bench.metric_reader("memset_ms", str(root))(_trace()) == 5e-3


def test_readers_read_a_trace_and_stay_silent_on_nothing():
    t = _trace()
    read = {n: bench.metric_reader(n, ROOT) for n in
            ("oracle_ms", "torch_ops_ms", "device_ops",
             "device_idle_pct.step", "cg_ms", "closest_hit_roofline_pct")}
    assert read["oracle_ms"](t) == 20e-3
    assert read["torch_ops_ms"](t) == 5e-3
    assert read["device_ops"](t) == 1.0
    assert read["device_idle_pct.step"](t) == pytest.approx(50.0)
    assert read["cg_ms"](t) is None
    assert read["closest_hit_roofline_pct"](
        _trace(device=[("memset", 0.0, 1.0)])) is None


def test_port_kernels_are_read_from_the_sources():
    import drt_tpu_torch
    names = tracing.port_kernels(os.path.dirname(drt_tpu_torch.__file__))
    assert {"closest_hit_kernel", "candidates_kernel", "pack_kernel",
            "bounce_fwd_kernel", "bounce_bwd_kernel", "ray_tail_fwd_kernel",
            "ray_tail_bwd_kernel", "scatter_cluster_kernel",
            "scatter_upfront_kernel", "scatter_pass_kernel",
            "scatter_reduce_kernel", "cg_kernel",
            "cg_shared_kernel"} <= names


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "parity-step-45k", "--seed", "4294967301",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "drt_tpu_torch_extra", object())
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "drt_tpu.config", object())
    assert bench.forbidden_modules() == ["drt_tpu"]


def test_the_yardstick_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.reference.step, port_bench.capture\n"
            "import port_bench.traffic, port_bench.meshio\n"
            "import port_bench.tracing\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
            "             & {'drt_tpu_torch', 'drt_tpu', 'jax', 'jaxlib'})\n"
            "print(bad)" % ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
