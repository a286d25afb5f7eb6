"""The port's command line (`python -m drt_tpu_torch.cli`) on the CPU against
the JAX package's (`drt_tpu.cli`): the same subcommands, option strings,
defaults and help texts but for `--backend`'s choices and `--device`; the
front end of `reconstruct` (HyperParams, capture and first mesh, with
`optimize` replaced in both packages by a recorder) equal for a synthetic
capture and for an h5 capture with a carved first mesh; `remesh`, `carve`
and `evaluate` equal outputs; `render` equal pixels but for shared-edge ties;
one real `reconstruct` subprocess from an h5 file; the advanced optimizer
stack; and `--device cuda` refused before any work where torch sees no
card. Both `main`s run in-process where a subprocess is not the point."""

import argparse
import dataclasses
import os
import subprocess
import sys

import imageio
import numpy as np
import pytest
import torch

import drt_tpu.cli as JCLI
import drt_tpu_torch.cli as TCLI
from drt_tpu.data.views import ViewBatch as JViews
from drt_tpu_torch.data.captured import save_h5_capture
from drt_tpu_torch.data.synthetic import synthesize_capture
from drt_tpu_torch.mesh import load_ply, save_ply
from drt_tpu_torch.mesh.topology import build_topology
from drt_tpu_torch.remesh import hausdorff_distance
from tests.meshes import make_icosphere

torch.set_num_threads(min(2, torch.get_num_threads()))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIE_PER_1024 = 2
BACKENDS = {"pallas": "cuda"}      # the JAX package's name -> the port's


class _Stop(Exception):
    pass


def _parser(mod):
    """The ArgumentParser that `mod.main` builds."""
    seen = {}

    def grab(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Stop):
            mod.main([])
    return seen["parser"]


def _subcommands(parser):
    (sub,) = [a for a in parser._actions
              if isinstance(a, argparse._SubParsersAction)]
    return sub.choices, {a.dest: a.help for a in sub._choices_actions}


def _options(parser, port):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        if port and a.dest == "device":
            continue
        choices = a.choices
        if not port and a.dest == "backend" and choices:
            choices = [BACKENDS.get(c, c) for c in choices]
        out[tuple(a.option_strings)] = (
            a.dest, a.default, a.type, choices and list(choices), a.required,
            a.help, a.nargs, a.const, type(a).__name__)
    return out


def test_option_strings_and_defaults_equal_the_jax_cli():
    jp, tp = _parser(JCLI), _parser(TCLI)
    jsub, jhelp = _subcommands(jp)
    tsub, thelp = _subcommands(tp)
    assert list(tsub) == list(jsub) == ["reconstruct", "evaluate", "render",
                                        "carve", "remesh"]
    assert thelp == jhelp
    for name in jsub:
        assert _options(tsub[name], True) == _options(jsub[name], False), name
        dev = [a for a in tsub[name]._actions if a.dest == "device"]
        if name in ("reconstruct", "render", "carve"):
            assert [(a.option_strings, a.default) for a in dev] == [
                (["--device"], "cuda")]
        else:
            assert not dev
    back = [a for a in tsub["reconstruct"]._actions if a.dest == "backend"]
    assert back[0].choices == ["auto", "brute", "culled", "cuda"]


def test_data_path_default_mirrors_the_jax_package():
    import drt_tpu.config as JC
    import drt_tpu_torch.config as TC
    assert TC.DEFAULT_DATA_PATH.endswith(os.path.join("reference", "data",
                                                      ""))
    assert JC.DEFAULT_DATA_PATH.endswith("/reference/data/")
    assert TCLI.DEFAULT_DATA_PATH == TC.DEFAULT_DATA_PATH


# -- reconstruct: the front end, with optimize recorded ----------------------

def _rotated_sphere(subdivisions, seed=2):
    """An icosphere rotated off the coordinate planes, whose edges would
    otherwise hold whole pixel columns of the ring cameras (shared-edge
    ties between the two packages' oracles)."""
    v, f = make_icosphere(subdivisions=subdivisions, radius=50.0)
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    return v @ q.T, f


class _Mesh:
    def __init__(self, v, f):
        self.v, self.f = np.asarray(v, np.float64), np.asarray(f, np.int64)

    def host_arrays(self):
        return self.v, self.f


def _record_optimize(monkeypatch, module):
    """Replace `module.optimize` with a recorder that returns the first
    mesh."""
    calls = []

    def fake(hp, data, v, f, **kw):
        calls.append(dict(hp=hp, data=data, v=np.asarray(v),
                          f=np.asarray(f), kw=kw))
        return _Mesh(v, f)
    monkeypatch.setattr(module, "optimize", fake)
    return calls


def _run_both(monkeypatch, tmp_path, argv):
    """`reconstruct argv` through both CLIs, each in its own working
    directory; returns (JAX call, port call)."""
    import drt_tpu.optimize
    import drt_tpu.utils
    import drt_tpu_torch.optimize
    monkeypatch.setattr(drt_tpu.utils, "enable_compilation_cache",
                        lambda: None)
    jcalls = _record_optimize(monkeypatch, drt_tpu.optimize)
    tcalls = _record_optimize(monkeypatch, drt_tpu_torch.optimize)
    for sub, mod, extra in (("jax", JCLI, []),
                            ("port", TCLI, ["--device", "cpu"])):
        os.makedirs(tmp_path / sub)
        monkeypatch.chdir(tmp_path / sub)
        mod.main(["reconstruct", *argv, *extra,
                  "--result-dir", str(tmp_path / sub / "out")])
    assert len(jcalls) == len(tcalls) == 1
    j, t = jcalls[0], tcalls[0]
    for sub, call in (("jax", j), ("port", t)):
        v, f = load_ply(str(tmp_path / sub / "out" / f"{call['hp'].name}"
                            "_recons.ply"))
        np.testing.assert_array_equal(f, call["f"])
    return j, t


def _assert_same_hp(jhp, thp):
    jd, td = dataclasses.asdict(jhp), dataclasses.asdict(thp)
    jd["backend"] = BACKENDS.get(jd["backend"], jd["backend"])
    assert td == jd


def _views(cap):
    out = {}
    for k in JViews._fields:
        x = getattr(cap.views, k)
        out[k] = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return out


def _assert_same_call_kwargs(j, t):
    assert t["kw"].pop("device") == torch.device("cpu")
    assert t["kw"] == j["kw"]


def test_reconstruct_front_end_synthetic_matches_jax_cli(monkeypatch,
                                                         tmp_path):
    gt_v, gt_f = _rotated_sphere(2)
    v0, f0 = make_icosphere(subdivisions=1, radius=45.0)
    save_ply(str(tmp_path / "gt.ply"), gt_v, gt_f)
    save_ply(str(tmp_path / "init.ply"), v0, f0)
    j, t = _run_both(monkeypatch, tmp_path, [
        "--name", "sphere", "--data", "synthetic",
        "--gt-mesh", str(tmp_path / "gt.ply"),
        "--init-mesh", str(tmp_path / "init.ply"),
        "--views", "4", "--resy", "24", "--resx", "32", "--ior", "1.5",
        "--passes", "3", "--iters", "7", "--num-view", "3",
        "--backend", "brute", "--start-len", "9", "--end-len", "4",
        "--seed", "5", "--momentum", "0.9", "--metrics", "m.jsonl"])
    _assert_same_hp(j["hp"], t["hp"])
    assert t["hp"].num_view == 3 and t["hp"].coarsen_policy == "auto"
    _assert_same_call_kwargs(j, t)
    jc, tc = j["data"], t["data"]
    assert ((tc.name, tc.resy, tc.resx, tc.num_views, tc.num_view_used)
            == (jc.name, jc.resy, jc.resx, jc.num_views, jc.num_view_used))
    a, b = _views(jc), _views(tc)
    for k in ("R", "K", "R_inv", "K_inv", "origin"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_allclose(b["ray_dir"], a["ray_dir"], rtol=0,
                               atol=1e-6)
    n_rays = a["valid"].size
    allowed = TIE_PER_1024 * n_rays // 1024
    assert int((a["valid"] != b["valid"]).sum()) <= allowed
    assert int(((a["mask"] >= 0.5) != (b["mask"] >= 0.5)).sum()) <= allowed
    both = a["valid"] & b["valid"]
    assert both.sum() > 100
    np.testing.assert_allclose(b["screen_pixel"][both],
                               a["screen_pixel"][both], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_array_equal(t["v"], j["v"])
    np.testing.assert_array_equal(t["f"], j["f"])
    # the shared capture cache, written by each CLI in its own directory
    name = "result/capture_cache/sphere_4v_24x32.npz"
    assert (tmp_path / "jax" / name).exists()
    assert (tmp_path / "port" / name).exists()


@pytest.fixture(scope="module")
def mouse_h5(tmp_path_factory):
    """A 6-view Pointgray capture of a rotated sphere at 32x40, written in
    the reference schema by the port."""
    d = tmp_path_factory.mktemp("h5")
    gt_v, gt_f = _rotated_sphere(2)
    cap = synthesize_capture(gt_v, gt_f, name="mouse", num_views=6, resy=32,
                             resx=40, ior=1.5, num_view_used=6, device="cpu")
    path = str(d / "mouse.h5")
    save_h5_capture(cap, path)
    return path, gt_v, gt_f


def test_reconstruct_front_end_h5_carved_matches_jax_cli(monkeypatch,
                                                         tmp_path, mouse_h5):
    path, _, _ = mouse_h5
    j, t = _run_both(monkeypatch, tmp_path, [
        "--name", "mouse", "--data", path, "--init", "carved",
        "--carve-res", "48", "--start-len", "8", "--end-len", "5",
        "--num-view", "4", "--optimizer", "adam", "--precond", "sobolev",
        "--backend", "brute", "--no-remesh", "--resume"])
    _assert_same_hp(j["hp"], t["hp"])
    _assert_same_call_kwargs(j, t)
    assert t["kw"]["remesh_fn"] is None and t["kw"]["resume"] is True
    jc, tc = j["data"], t["data"]
    assert (tc.num_views, tc.num_view_used) == (6, 4) == (
        jc.num_views, jc.num_view_used)
    a, b = _views(jc), _views(tc)
    for k in JViews._fields:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    # the carved first mesh: the occupancy agrees bit for bit, so the
    # hulls do
    np.testing.assert_array_equal(t["f"], j["f"])
    np.testing.assert_allclose(t["v"], j["v"], rtol=0, atol=1e-9)
    assert build_topology(t["f"], len(t["v"])).is_watertight


# -- remesh, evaluate, carve, render -------------------------------------------

def _main_out(mod, argv, capsys):
    mod.main(argv)
    return capsys.readouterr().out


def _ply_bytes(path):
    """A PLY file's bytes, its header's "generated by" comment aside."""
    return open(path, "rb").read().replace(b"comment drt_tpu_torch ",
                                           b"comment drt_tpu ")


def test_remesh_evaluate_carve_equal_the_jax_cli(tmp_path, capsys, mouse_h5):
    v, f = _rotated_sphere(3)
    src = str(tmp_path / "in.ply")
    save_ply(src, v, f)
    outs = {}
    for sub, mod in (("jax", JCLI), ("port", TCLI)):
        out = str(tmp_path / f"{sub}_remeshed.ply")
        printed = _main_out(mod, ["remesh", "--mesh", src, "--out", out,
                                  "--target-len", "8"], capsys)
        assert printed.startswith(f"{src}: V={len(v)}/F={len(f)} -> V=")
        ev = _main_out(mod, ["evaluate", "--mesh", out, "--gt", src], capsys)
        ev1 = _main_out(mod, ["evaluate", "--mesh", out, "--gt", src,
                              "--one-sided"], capsys)
        carved = str(tmp_path / f"{sub}_carved.ply")
        extra = ["--device", "cpu"] if sub == "port" else []
        cv = _main_out(mod, ["carve", "--name", "mouse", "--data",
                             mouse_h5[0], "--carve-res", "48",
                             "--target-len", "8", "--out", carved, *extra],
                       capsys)
        outs[sub] = (_ply_bytes(out), ev, ev1, _ply_bytes(carved),
                     (printed + cv).replace(f"{sub}_", ""))
    j, t = outs["jax"], outs["port"]
    assert t[0] == j[0]                         # remeshed PLY
    assert t[1] == j[1] and t[1].startswith("mean=")
    assert t[2] == j[2] and t[1] != t[2]
    assert float(t[1].split("mean=")[1].split()[0]) < 1.0
    assert t[3] == j[3]                         # carved PLY
    assert t[4] == j[4]
    cv_v, cv_f = load_ply(str(tmp_path / "port_carved.ply"))
    assert build_topology(cv_f, len(cv_v)).is_watertight


def test_render_pixels_equal_the_jax_cli(tmp_path, capsys):
    v, f = _rotated_sphere(2)
    src = str(tmp_path / "ball.ply")
    save_ply(src, v, f)
    for sub, mod in (("jax", JCLI), ("port", TCLI)):
        extra = ["--device", "cpu"] if sub == "port" else []
        printed = _main_out(mod, ["render", "--mesh", src, "--res", "64",
                                  "--backend", "brute", "--out-dir",
                                  str(tmp_path / sub), *extra], capsys)
        assert printed.strip() == (f"wrote ball_mask/valid/exitdir.png to "
                                   f"{tmp_path / sub}")
    img = {(sub, kind): np.asarray(imageio.imread(
        str(tmp_path / sub / f"ball_{kind}.png")))
        for sub in ("jax", "port") for kind in ("mask", "valid", "exitdir")}
    allowed = TIE_PER_1024 * 64 * 64 // 1024
    for kind in ("mask", "valid"):
        a, b = img[("jax", kind)], img[("port", kind)]
        assert a.shape == b.shape == (64, 64) and a.max() == 255
        assert int((a != b).sum()) <= allowed, kind
    a, b = img[("jax", "exitdir")], img[("port", "exitdir")]
    assert a.shape == b.shape == (64, 64, 3)
    same = (img[("jax", "valid")] == img[("port", "valid")])
    # on the rays both sides find valid, at most one level apart (float32
    # directions in two implementations, then a truncation to uint8)
    d = np.abs(a.astype(int) - b.astype(int))[same]
    assert d.max() <= 1
    assert int((d > 0).sum()) <= allowed


# -- whole runs ---------------------------------------------------------------

def test_cli_reconstruct_from_h5_subprocess(tmp_path):
    """`python -m drt_tpu_torch.cli reconstruct --device cpu --data file.h5
    --init carved` sized as tests/test_h5_e2e.py runs the JAX package's (8
    views at 48x64, carve at 48^3, 2 passes from edge length 8 to 5) and
    held to the same bar: within Hausdorff mean 5 of the radius-50 sphere.
    6 steps a pass where that test takes 40: on the CPU the port's plain
    oracle takes 0.7-1.8 s a step here."""
    gt_v, gt_f = make_icosphere(subdivisions=3, radius=50.0)
    cap = synthesize_capture(gt_v, gt_f, name="mouse", num_views=8, resy=48,
                             resx=64, ior=1.4723, num_view_used=8,
                             device="cpu")
    h5_path = str(tmp_path / "mouse.h5")
    save_h5_capture(cap, h5_path)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-m", "drt_tpu_torch.cli", "reconstruct",
         "--device", "cpu", "--name", "mouse", "--data", h5_path,
         "--init", "carved", "--carve-res", "48",
         "--passes", "2", "--iters", "6", "--backend", "cuda",
         "--start-len", "8", "--end-len", "5",
         "--result-dir", str(tmp_path)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "carved hull: V=" in out.stdout
    v, f = load_ply(str(tmp_path / "mouse_recons.ply"))
    assert build_topology(f, len(v)).is_watertight
    h = hausdorff_distance(v, f, gt_v, gt_f)
    assert h.mean < 5.0, f"H.mean={h.mean}"
    assert sorted(os.listdir(tmp_path / "result" / "checkpoints")) == [
        "mouse_pass00.ply", "mouse_pass01.ply"]


def test_cli_reconstruct_advanced_stack(monkeypatch, tmp_path, capsys):
    """tests/test_cli.py's advanced stack (uadam + h1 + len, Huber,
    bilinear mask) through the port's `main`."""
    gt_v, gt_f = make_icosphere(subdivisions=3, radius=50.0)
    v0, f0 = make_icosphere(subdivisions=2, radius=50.0)
    save_ply(str(tmp_path / "gt.ply"), gt_v, gt_f)
    save_ply(str(tmp_path / "init.ply"), v0, f0)
    monkeypatch.chdir(tmp_path)
    TCLI.main(["reconstruct", "--device", "cpu", "--name", "sphere",
               "--data", "synthetic", "--gt-mesh", str(tmp_path / "gt.ply"),
               "--init-mesh", str(tmp_path / "init.ply"),
               "--views", "6", "--resy", "48", "--resx", "48",
               "--ior", "1.5", "--passes", "2", "--iters", "5",
               "--start-len", "12", "--end-len", "8",
               "--num-view", "6", "--backend", "cuda",
               "--optimizer", "uadam", "--precond", "h1",
               "--lr-schedule", "len", "--huber", "0.05",
               "--bilinear-mask", "--silhouette-budget", "512",
               "--ray-chunk", "0",
               "--result-dir", str(tmp_path / "out")])
    printed = capsys.readouterr().out
    assert "pass 1: remesh_len 8 lr 0.0666667" in printed
    v, f = load_ply(str(tmp_path / "out" / "sphere_recons.ply"))
    assert np.isfinite(v).all() and len(f) > 0
    assert build_topology(f, len(v)).is_watertight


@pytest.mark.parametrize("cmd", ["reconstruct", "render", "carve"])
def test_device_cuda_without_a_card_exits_before_work(monkeypatch, tmp_path,
                                                      cmd):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    import drt_tpu_torch.data
    import drt_tpu_torch.mesh

    def no_work(*a, **k):
        raise AssertionError("work started")
    for mod, name in ((drt_tpu_torch.data, "synthesize_capture"),
                      (drt_tpu_torch.data, "load_h5_capture"),
                      (drt_tpu_torch.mesh, "load_ply"),
                      (drt_tpu_torch.mesh, "build_mesh_state")):
        monkeypatch.setattr(mod, name, no_work)
    monkeypatch.chdir(tmp_path)
    argv = {"reconstruct": ["reconstruct", "--gt-mesh", "x.ply"],
            "render": ["render", "--mesh", "x.ply"],
            "carve": ["carve", "--gt-mesh", "x.ply", "--out", "x.ply"]}[cmd]
    with pytest.raises(SystemExit) as e:
        TCLI.main(argv)
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)
    assert os.listdir(tmp_path) == []
