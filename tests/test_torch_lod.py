"""The LOD loop `drt_tpu_torch.optimize.optimize` on the CPU: one small
float64 run with the isotropic remesher against the JAX package's `optimize`
(faces equal, vertices at rtol 1e-6, atol 1e-6 of the largest coordinate),
and its behaviours mirrored from tests/test_lod.py (Hausdorff falls
with remeshing, retry then keep, budget guard, `len` schedule, coarsen
policies, resume, metrics, the shared .npz capture cache)."""

import functools
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.mesh as JMESH
import drt_tpu.optimize.loop as JLOOP
from drt_tpu.config import HyperParams as JHP
from drt_tpu.data.synthetic import synthesize_capture as j_synth
from drt_tpu.data.views import CaptureData as JCapture
from drt_tpu.data.views import ViewBatch as JViews
from drt_tpu_torch.config import HyperParams
from drt_tpu_torch.convert import view_batch_from_arrays
from drt_tpu_torch.data.synthetic import synthesize_capture
from drt_tpu_torch.data.views import CaptureData
from drt_tpu_torch.mesh import build_mesh_state, load_ply
from drt_tpu_torch.optimize import find_resume_pass, optimize
from drt_tpu_torch.optimize.schedules import interp_reciprocal
from drt_tpu_torch.remesh import hausdorff_distance
from tests.meshes import make_icosphere

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

RADIUS = 50.0


def _quiet(_s):
    pass


@pytest.fixture(scope="module")
def small_cap():
    """4 views of a subdivision-2 sphere at 24x24, float32, on the CPU."""
    gt_v, gt_f = make_icosphere(subdivisions=2, radius=RADIUS)
    cap = synthesize_capture(gt_v, gt_f, name="sphere", num_views=4,
                             resy=24, resx=24, ior=1.5, backend="brute",
                             num_view_used=4, device="cpu")
    return gt_v, gt_f, cap


def _hp(**kw):
    base = dict(name="sphere", ior=1.5, num_passes=2, iters=1,
                start_len=12.0, end_len=8.0, backend="brute",
                silhouette_budget=256, num_view=4)
    base.update(kw)
    return HyperParams(**base)


def test_hyperparams_mirror_the_jax_package():
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(JHP)}
    tf = {f.name: f.default for f in dataclasses.fields(HyperParams)}
    assert jf == tf
    assert HyperParams().replace(iters=3).iters == 3
    import drt_tpu.config as JC
    import drt_tpu_torch.config as TC
    for name in ("REDMI_OBJECTS", "POINTGRAY_OBJECTS", "POINTGRAY_RES",
                 "REDMI_RES"):
        assert getattr(TC, name) == getattr(JC, name)
    # the reference data directory: the JAX package's fixed path, the port's
    # under the home of whoever runs it (only the CLI reads it)
    assert os.path.basename(os.path.dirname(
        os.path.dirname(TC.DEFAULT_DATA_PATH))) == "reference"
    assert TC.DEFAULT_DATA_PATH.endswith(os.sep + "data" + os.sep)
    assert JC.DEFAULT_DATA_PATH.endswith("/reference/data/")


def test_optimize_matches_jax_package_in_float64(monkeypatch):
    """2 passes x 3 iterations with the isotropic remesher from a rotated,
    bumpy icosphere: the same remeshed faces, the same vertices. The JAX
    `optimize` builds float32 mesh states whatever `hp.dtype` says, so the test
    hands it a float64 `build_mesh_state` (nothing in the package changes)."""
    gt_v, gt_f = make_icosphere(subdivisions=3, radius=RADIUS)
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    gt_v = gt_v @ q.T
    cap32 = j_synth(gt_v, gt_f, name="sphere", num_views=6, resy=24,
                    resx=24, ior=1.5, backend="brute", num_view_used=6)
    arrays = {k: np.asarray(getattr(cap32.views, k), np.float64)
              for k in JViews._fields}
    arrays["valid"] = np.asarray(cap32.views.valid)
    v0, f0 = make_icosphere(subdivisions=2, radius=RADIUS)
    v0 = (v0 * np.clip(1 + 0.08 * rng.standard_normal(len(v0))[:, None],
                       0.9, 1.1)) @ q.T
    kw = dict(name="sphere", ior=1.5, num_passes=2, iters=3, start_len=14.0,
              end_len=9.0, backend="brute", silhouette_budget=512,
              num_view=6, dtype="float64")

    with jax.enable_x64(True):
        monkeypatch.setattr(JLOOP, "build_mesh_state", functools.partial(
            JMESH.build_mesh_state, dtype=jnp.float64))
        jcap = JCapture(name="sphere", resy=24, resx=24, num_views=6,
                        views=JViews(**{k: jnp.asarray(arrays[k])
                                        for k in JViews._fields}),
                        num_view_used=6)
        jlines = []
        jout = JLOOP.optimize(JHP(**kw), jcap, v0, f0,
                              remesh_fn="isotropic", log_fn=jlines.append,
                              log_every=1)
        assert jout.vertices.dtype == jnp.float64
        jv, jf = jout.host_arrays()

    tcap = CaptureData(name="sphere", resy=24, resx=24, num_views=6,
                       views=view_batch_from_arrays(arrays, "cpu"),
                       num_view_used=6)
    tlines, info = [], {}
    tout = optimize(HyperParams(**kw), tcap, v0, f0, remesh_fn="isotropic",
                    log_fn=tlines.append, log_every=1, run_info=info,
                    device="cpu")
    assert tout.vertices.dtype == torch.float64
    tv, tf = tout.host_arrays()
    np.testing.assert_array_equal(tf, jf)
    assert len(tf) != len(f0)
    np.testing.assert_allclose(tv, jv, rtol=1e-6,
                               atol=1e-6 * np.abs(jv).max())
    assert np.abs(tv - jv).max() < 1e-6 * np.abs(jv).max()

    def losses(lines):
        return [float(m.group(1)) for m in
                (re.search(r"loss=(\S+)", ln) for ln in lines) if m]
    assert len(losses(tlines)) == 6
    np.testing.assert_allclose(losses(tlines), losses(jlines), rtol=1e-5)
    assert info["remesher"] == "native" and info["remesh_failures"] == 0
    assert [p["pass"] for p in info["passes"]] == [0, 1]
    assert info["passes"][1]["faces"] == len(tf)


def test_lod_optimization_with_remesh(tmp_path):
    gt_v, gt_f = make_icosphere(subdivisions=3, radius=RADIUS)
    cap = synthesize_capture(gt_v, gt_f, name="sphere", num_views=12,
                             resy=32, resx=32, ior=1.5, backend="brute",
                             num_view_used=12, device="cpu")
    rng = np.random.default_rng(11)
    v0, f0 = make_icosphere(subdivisions=2, radius=RADIUS)
    v_init = v0 * np.clip(1.0 + 0.10 * rng.standard_normal(len(v0))[:, None],
                          0.88, 1.12)
    hp = _hp(iters=30, silhouette_budget=512, num_view=12, backend="auto")
    metrics_path = str(tmp_path / "m" / "metrics.jsonl")
    out = optimize(hp, cap, v_init, f0, remesh_fn="isotropic",
                   checkpoint_dir=str(tmp_path / "ck"), log_fn=_quiet,
                   metrics=metrics_path, device="cpu")
    v_out, f_out = out.host_arrays()
    assert len(v_out) != len(v0)              # the remesh changed topology
    before = hausdorff_distance(v_init, f0, gt_v, gt_f)
    after = hausdorff_distance(v_out, f_out, gt_v, gt_f)
    assert after.mean < before.mean, (before, after)
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "sphere_pass00.ply", "sphere_pass01.ply"]
    v_ck, f_ck = load_ply(str(tmp_path / "ck" / "sphere_pass01.ply"))
    np.testing.assert_array_equal(f_ck, f_out)
    np.testing.assert_allclose(v_ck, v_out, rtol=1e-6, atol=1e-5)
    recs = [json.loads(ln) for ln in open(metrics_path)]
    assert [r["event"] for r in recs if "event" in r] == ["remesh"] * 2
    its = [r for r in recs if "iter" in r]
    assert len(its) == 2 and all(np.isfinite(r["loss"]) for r in its)
    assert {"ray", "vh", "sm", "max_grad", "valid_rays"} <= set(its[0])


def test_remesh_retry_keeps_mesh_on_persistent_failure(small_cap):
    gt_v, gt_f, cap = small_cap
    attempts = []

    def bad_remesh(v, f, target_len):
        attempts.append(target_len)
        raise ValueError("mesh is not watertight")

    lines, info = [], {}
    out = optimize(_hp(num_passes=1), cap, gt_v, gt_f, remesh_fn=bad_remesh,
                   log_fn=lines.append, run_info=info, device="cpu")
    assert attempts == [12.0, 12.0 * 0.8]
    assert any("keeping the current mesh" in ln for ln in lines)
    assert len(out.host_arrays()[0]) == len(gt_v)
    assert (info["remesh_attempts"], info["remesh_retries"],
            info["remesh_failures"]) == (2, 1, 1)

    # one failure, then success at 0.8x: a retry and no failure
    calls = []

    def flaky(v, f, target_len):
        calls.append(target_len)
        if len(calls) == 1:
            raise RuntimeError("collapse cascade")
        return v, f
    info = {}
    optimize(_hp(num_passes=1), cap, gt_v, gt_f, remesh_fn=flaky,
             log_fn=_quiet, run_info=info, device="cpu")
    assert (info["remesh_attempts"], info["remesh_retries"],
            info["remesh_failures"]) == (2, 1, 0)


def test_silhouette_budget_guard_grows(small_cap):
    gt_v, gt_f, cap = small_cap
    lines, info = [], {}
    optimize(_hp(silhouette_budget=8), cap, gt_v, gt_f, remesh_fn=None,
             log_fn=lines.append, run_info=info, device="cpu")
    warn = [ln for ln in lines if "exceeded the sampling budget" in ln]
    assert warn and "budget grows to" in warn[0]
    grown = int(re.search(r"budget grows to (\d+)", warn[0]).group(1))
    assert [p["budget"] for p in info["passes"]] == [8, grown]
    assert grown > 8 and grown & (grown - 1) == 0


def test_silh_max_carried_in_step_state(small_cap):
    """The running silhouette-edge maximum sees every iteration, logged or
    not, and stays on the device."""
    from drt_tpu_torch.intersect import get_intersect_fn
    from drt_tpu_torch.optimize import LossWeights, make_train_step
    gt_v, gt_f, cap = small_cap
    ms = build_mesh_state(gt_v, gt_f, device="cpu")
    weights = LossWeights(ray_w=40.0, vh_w=2e-3, sm_w=0.08, ior=1.5)
    init_state, step, _ = make_train_step(
        get_intersect_fn("brute"), weights, 24, 24, silhouette_budget=8)
    state = init_state(ms)
    seen = []
    for it in range(3):
        silh = [(it + k) % 4 for k in range(8)]
        state, _loss, aux = step(state, 0.0, ms, cap.views, 0, silh)
        seen.append(int(aux["silh_edge_max"]))
    assert int(state["silh_max"]) == max(seen) > 8


def test_len_tracking_lr_schedule(small_cap):
    gt_v, gt_f, cap = small_cap
    lines = []
    optimize(_hp(lr_schedule="len", optimizer="uadam", start_lr=0.1), cap,
             gt_v, gt_f, remesh_fn=None, log_fn=lines.append, device="cpu")
    lrs = {}
    for ln in lines:
        m = re.match(r"pass (\d+): remesh_len ([\d.]+) lr ([\d.]+)", ln)
        if m:
            lrs[int(m.group(1))] = (float(m.group(2)), float(m.group(3)))
    assert set(lrs) == {0, 1}
    for i_pass, (remesh_len, lr) in lrs.items():
        expect = interp_reciprocal(12.0, 8.0, i_pass, 2)
        assert abs(remesh_len - expect) < 1e-4
        assert abs(lr - 0.1 * expect / 12.0) < 1e-4
    assert lrs[0][1] == 0.1 and lrs[1][1] < 0.1


@pytest.mark.parametrize("policy,skips", [("skip", True), ("auto", True),
                                          ("schedule", False),
                                          ("clamp", False)])
def test_coarsen_policies(policy, skips):
    """While the schedule (30 -> 24) is coarser than the init's mean edge
    (~10): skip and auto (below 480 rows) leave the topology alone, schedule
    coarsens, clamp remeshes at the init's own length."""
    gt_v, gt_f = make_icosphere(subdivisions=3, radius=RADIUS)
    cap = synthesize_capture(gt_v, gt_f, name="sphere", num_views=4,
                             resy=32, resx=32, ior=1.5, backend="brute",
                             num_view_used=4, device="cpu")
    hp = _hp(iters=2, vh_w=0.0, start_len=30.0, end_len=24.0,
             coarsen_policy=policy)
    lines = []
    out = optimize(hp, cap, gt_v, gt_f, remesh_fn="isotropic",
                   log_fn=lines.append, device="cpu")
    _, f_out = out.host_arrays()
    assert any("remesh skipped" in s for s in lines) == skips
    assert any("auto -> skip" in s for s in lines) == (policy == "auto")
    if skips:
        assert len(f_out) == len(gt_f)
    elif policy == "schedule":
        assert len(f_out) < len(gt_f) // 2
    else:
        assert len(gt_f) // 2 < len(f_out) < 2 * len(gt_f)
        tri = gt_v[gt_f]
        init_len = np.linalg.norm(tri - np.roll(tri, -1, axis=1),
                                  axis=2).mean()
        assert f"pass 0: remesh_len {init_len:g} " in lines[1]
    # no_coarsen is the alias of "clamp"
    if policy == "clamp":
        lines2 = []
        optimize(hp.replace(coarsen_policy="schedule", no_coarsen=True,
                            num_passes=1), cap, gt_v, gt_f, remesh_fn=None,
                 log_fn=lines2.append, device="cpu")
        assert lines2[0] == lines[1]          # the same clamped length
    with pytest.raises(ValueError, match="coarsen_policy"):
        optimize(hp.replace(coarsen_policy="never"), cap, gt_v, gt_f,
                 log_fn=_quiet, device="cpu")


def test_resume_runs_only_the_missing_passes(small_cap, tmp_path):
    gt_v, gt_f, cap = small_cap
    ck = str(tmp_path)
    assert find_resume_pass(ck, "sphere") is None
    optimize(_hp(num_passes=2, iters=2), cap, gt_v, gt_f, remesh_fn=None,
             checkpoint_dir=ck, log_fn=_quiet, device="cpu")
    assert find_resume_pass(ck, "sphere") == (
        1, os.path.join(ck, "sphere_pass01.ply"))
    lines, info = [], {}
    out = optimize(_hp(num_passes=3, iters=2), cap, gt_v, gt_f,
                   remesh_fn=None, checkpoint_dir=ck, log_fn=lines.append,
                   resume=True, run_info=info, device="cpu")
    assert any("resuming from pass 1" in ln for ln in lines)
    assert [p["pass"] for p in info["passes"]] == [2]
    assert sorted(os.listdir(ck)) == [f"sphere_pass0{i}.ply"
                                      for i in range(3)]
    v_ck, _ = load_ply(os.path.join(ck, "sphere_pass02.ply"))
    np.testing.assert_allclose(out.host_arrays()[0], v_ck, atol=1e-5)
    # nothing left to do: the last checkpoint comes back untouched
    info = {}
    optimize(_hp(num_passes=3, iters=2), cap, gt_v, gt_f, remesh_fn=None,
             checkpoint_dir=ck, log_fn=_quiet, resume=True, run_info=info,
             device="cpu")
    assert info["passes"] == []


def test_capture_cache_is_shared_with_the_jax_package(tmp_path):
    gt_v, gt_f = make_icosphere(subdivisions=2, radius=RADIUS)
    kw = dict(name="c", num_views=3, resy=16, resx=20, ior=1.5,
              backend="brute", num_view_used=3)
    # written by the port, loaded by both
    p1 = str(tmp_path / "a" / "port.npz")
    fresh = synthesize_capture(gt_v, gt_f, cache_path=p1, device="cpu", **kw)
    assert os.path.exists(p1)
    again = synthesize_capture(gt_v * 0, gt_f, cache_path=p1, device="cpu",
                               **kw)           # loaded, not rendered
    jload = j_synth(gt_v * 0, gt_f, cache_path=p1, **kw)
    # written by the JAX package, loaded by the port
    p2 = str(tmp_path / "jax.npz")
    jfresh = j_synth(gt_v, gt_f, cache_path=p2, **kw)
    tload = synthesize_capture(gt_v * 0, gt_f, cache_path=p2, device="cpu",
                               **kw)
    assert set(np.load(p1).files) == set(np.load(p2).files)
    for k in JViews._fields:
        a = getattr(fresh.views, k).numpy()
        np.testing.assert_array_equal(getattr(again.views, k).numpy(), a)
        np.testing.assert_array_equal(np.asarray(getattr(jload.views, k)), a)
        np.testing.assert_array_equal(
            getattr(tload.views, k).numpy(),
            np.asarray(getattr(jfresh.views, k)))
    assert (tload.resy, tload.resx, tload.num_views) == (16, 20, 3)
    assert int(fresh.views.valid.sum()) > 10


def test_cuda_device_without_a_card_raises(small_cap):
    """No fallback: `device="cuda"` (the default) raises where torch sees no
    card, and a capture on another device is refused."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    gt_v, gt_f, cap = small_cap
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize(_hp(), cap, gt_v, gt_f, log_fn=_quiet)
    with pytest.raises(ValueError, match="views are on"):
        optimize(_hp(), cap, gt_v, gt_f, log_fn=_quiet, device="meta")
