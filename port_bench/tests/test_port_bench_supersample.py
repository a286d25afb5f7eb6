"""The capture of a rig that states `"supersample"`, on the CPU at the tiny
cell's size: its lanes, its sub-rays against the port's
`generate_rays(supersample=)`, its screen points against direct traces by
the reference, its mask against the same rig's at s = 1; the committed
configurations' cache key; the reference's list of ray views; and the
closest-hit roofline's bytes."""

import json
import os
import types

import pytest
import torch

import tiny
from port_bench import bench, capture
from port_bench import traffic as traffic_gen
from port_bench.meshio import load_mesh
from port_bench.reference import step as ref
from port_bench.reference.mesh import ref_mesh
from port_bench.reference.oracle import Scene

# The cache key that every committed configuration's capture has had since
# the benchmark's first cell: a rig without "supersample" keeps it.
KEY = "3ac8223f73769f49"
S = 2
BLOCK = 1000        # a trace block that splits each view's sub-rays unevenly


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """(cfg at s = 1, cfg at s = S, gt, views at s = 1, views at s = S,
    the s = S capture's arrays made in blocks of BLOCK)."""
    tmp = tmp_path_factory.mktemp("supersample")
    root = tiny.make_root(str(tmp))
    cfg = bench.resolve("tiny", root)[1]
    cfg2 = dict(cfg, rig=dict(cfg["rig"], supersample=S))
    gt = load_mesh(root, cfg["ground_truth"])
    cache = str(tmp / "cache")
    views = capture.load(*gt, cfg, "cpu", cache)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(capture, "TRACE_BLOCK", BLOCK)
        views2 = capture.load(*gt, cfg2, "cpu", cache)
        made = capture.make(*gt, cfg2, "cpu")
    return cfg, cfg2, gt, views, views2, made


def test_a_supersampled_capture_has_s2_lanes_a_view(rig):
    cfg, _cfg2, _gt, views, views2, _made = rig
    r = cfg["rig"]
    n = S * S * r["resy"] * r["resx"]
    assert views2.screen_pixel.shape == (r["num_views"], n, 3)
    assert views2.valid.shape == views2.ray_dir.shape[:2] == (r["num_views"],
                                                              n)
    assert views2.mask.shape == views.mask.shape == (r["num_views"],
                                                     r["resy"], r["resx"])
    assert int(views2.valid.sum()) > S * S * int(views.valid.sum()) // 2


def test_sub_rays_are_the_ports_generate_rays(rig):
    from drt_tpu_torch.render.camera import CameraM, generate_rays
    cfg, _cfg2, _gt, _views, views2, _made = rig
    r = cfg["rig"]
    for i in range(r["num_views"]):
        cam = CameraM(views2.R[i], views2.K[i], views2.R_inv[i],
                      views2.K_inv[i])
        o, d = generate_rays(r["resy"], r["resx"], cam, supersample=S)
        assert torch.allclose(views2.origin[i].expand(o.shape), o, rtol=0,
                              atol=1e-6)
        assert float((views2.ray_dir[i] - d).abs().max()) <= 1e-6


def test_each_valid_sub_ray_meets_the_screen_where_its_own_trace_does(rig):
    """The capture made in blocks of BLOCK sub-rays against one trace of
    every sub-ray of the view by the reference: the same valid lanes, and
    each valid lane's screen point."""
    _cfg, cfg2, gt, _views, views2, made = rig
    mesh = ref_mesh(*gt, "cpu")
    scene = Scene(mesh.vertices, mesh.faces)
    rings = capture.ring(gt[0].astype("float64"), cfg2["rig"])
    for i, (_R, _K, spt, sn) in enumerate(rings):
        d = views2.ray_dir[i]
        o2, d2, lanes, esc, _ = ref.trace_exit(
            views2.origin[i].expand(d.shape), d, mesh.vertices, mesh.faces,
            scene, cfg2["ior"], cfg2["ext_ior"])
        sn_t = torch.as_tensor(sn, dtype=torch.float32)
        sp_t = torch.as_tensor(spt, dtype=torch.float32)
        denom = (d2 * sn_t).sum(-1)
        t = ((sp_t - o2) * sn_t).sum(-1) / denom
        ok = esc & (t > 0) & (denom.abs() > 1e-9)
        want = torch.zeros_like(views2.valid[i])
        want[lanes[ok]] = True
        assert torch.equal(views2.valid[i], want)
        assert torch.equal(torch.as_tensor(made[i][0]), lanes[ok])
        pts = (o2 + t[:, None] * d2)[ok]
        assert float((views2.screen_pixel[i][lanes[ok]] - pts).abs().max()
                     ) <= 1e-5 * float(pts.abs().max())


def test_the_mask_is_the_s1_captures(rig):
    _cfg, _cfg2, _gt, views, views2, _made = rig
    for k in ("mask", "R", "K", "R_inv", "K_inv", "origin"):
        assert torch.equal(getattr(views2, k), getattr(views, k)), k


def test_blocks_do_not_change_an_s1_capture(rig, monkeypatch):
    cfg, _cfg2, gt, _views, _views2, _made = rig
    whole = capture.make(*gt, cfg, "cpu")
    monkeypatch.setattr(capture, "TRACE_BLOCK", 100)
    for a, b in zip(whole, capture.make(*gt, cfg, "cpu")):
        assert all((x == y).all() for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["dog-pointgray-parity", "dog-pointgray-adv",
                                  "dog-pointgray-parity-pass7",
                                  "dog-pointgray-largesteps"])
def test_the_committed_configurations_keep_their_cache_key(name):
    cfg = bench.read_json(os.path.join(bench.BENCH_DIR, "configs",
                                       f"{name}.json"))
    assert "supersample" not in cfg["rig"]
    assert capture.supersample(cfg["rig"]) == 1
    assert capture.cache_key(cfg) == KEY
    cfg2 = dict(cfg, rig=dict(cfg["rig"], supersample=S))
    assert capture.cache_key(cfg2) != KEY


@pytest.mark.parametrize("s", [0, -1, 1.5, "2", True])
def test_a_supersample_that_is_not_a_whole_number_from_1_is_refused(s):
    with pytest.raises(ValueError, match="supersample"):
        capture.supersample({"name": "r", "supersample": s})


def test_the_reference_averages_a_list_of_ray_views(rig):
    """Ray views [a, b]: the mean of the one-view ray terms and the sum of
    their lanes, and the gradient of that mean. An int is `ray_loss` of
    that view, as before lists were taken, bit for bit; a list of one
    gives the same loss and ray gradient, and a step within rounding (the
    gradient's branches then sum in another order)."""
    cfg, _cfg2, gt, views, _views2, _made = rig
    mesh = ref_mesh(*gt, "cpu")
    v = mesh.vertices * 1.01
    w = (cfg["ray_w"], 0.0, 0.0)

    def loss(ray_view):
        p = v.clone().requires_grad_(True)
        total, parts, _ = ref.total_loss(p, mesh, views, ray_view, [], cfg, w)
        (g,) = torch.autograd.grad(total, p)
        return total.detach(), parts, g

    (ta, pa, ga), (tb, pb, gb) = loss(0), loss(2)
    t2, p2, g2 = loss([0, 2])
    assert p2["ray"] == torch.stack([pa["ray"], pb["ray"]]).mean()
    assert p2["lanes"] == pa["lanes"] + pb["lanes"] > 0
    assert float(t2) == pytest.approx(float(ta + tb) / 2, rel=1e-6)
    assert torch.allclose(g2, (ga + gb) / 2, rtol=1e-5, atol=1e-9)
    t1, p1, g1 = loss([0])
    assert torch.equal(t1, ta) and torch.equal(g1, ga) and p1 == pa
    scene = Scene(v, mesh.faces)
    for half in (False, True):
        got = ref.ray_views_loss(v, mesh, scene, views, 0, cfg, half, True)
        want = ref.ray_loss(v, mesh, scene, views, 0, cfg, half, True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[2] == want[2]
    state = ref.init_state(mesh)
    s_int = ref.step(state, cfg["lr"], mesh, views, 0, [1, 3], cfg)
    s_one = ref.step(state, cfg["lr"], mesh, views, [0], [1, 3], cfg)
    assert s_int[1] == pytest.approx(s_one[1], rel=1e-6)
    assert s_int[2] == pytest.approx(s_one[2], rel=1e-6)
    assert torch.allclose(s_int[0]["params"], s_one[0]["params"], rtol=1e-5,
                          atol=1e-9)


@pytest.mark.parametrize("ray_views", [1, 2])
def test_reference_steps_passes_the_whole_row_of_ray_views(rig, ray_views):
    cfg, _cfg2, gt, views, _views2, _made = rig
    mix = dict(traffic_gen.load("replay-blocks"), ray_views=ray_views)
    rays, silhs = traffic_gen.view_rows(mix, 4, 2 ** 31 + 3, 2)
    got = []

    def step(state, lr, mesh, views, ray_view, *a, **kw):
        got.append(ray_view)
        return ref.step(state, lr, mesh, views, ray_view, *a, **kw)

    stub = types.SimpleNamespace(precision=ref.precision,
                                 init_state=ref.init_state, step=step,
                                 first_grad=ref.first_grad)
    out = bench.reference_steps(cfg, stub, views, gt, rays, silhs, "cpu")
    assert got == [r[0] if ray_views == 1 else r for r in rays]
    assert all(type(g) is (int if ray_views == 1 else list) for g in got)
    assert len(out["losses"]) == 2


def test_the_roofline_counts_s2_lanes_a_ray_view():
    read = bench.metric_reader("closest_hit_roofline_pct")
    step_bytes = read.__globals__["step_bytes"]
    cfg = bench.read_json(os.path.join(bench.BENCH_DIR, "configs",
                                       "dog-pointgray-parity.json"))
    mix = traffic_gen.load("replay-blocks")
    mesh = (19_483, 38_962)
    r = cfg["rig"]
    lanes = r["resy"] * r["resx"]
    # the count before rigs could state "supersample"
    before = sum(32 * n + 12 * sum(mesh) for n in
                 3 * mix["ray_views"] * [lanes]
                 + mix["silh_views"] * [2 * cfg["silhouette_budget"]])
    assert step_bytes(cfg, mix, *mesh) == before
    cfg2 = dict(cfg, rig=dict(r, supersample=S))
    assert (step_bytes(cfg2, mix, *mesh) - before
            == 3 * mix["ray_views"] * 32 * (S * S - 1) * lanes)


def test_a_supersampled_cell_runs_through_the_harness(tmp_path):
    """The tiny cell with its rig at s = S, a change to its configuration's
    file alone: the program's eager step on S^2 lanes a pixel against the
    reference, `correct`."""
    root = tiny.make_root(str(tmp_path), limits={
        "loss_gap": 1e-4, "ray_gap": 1e-4, "lanes_gap": 1e-4,
        "grad_gap": 1e-4, "update_rule_gap": 1e-4})
    path = os.path.join(root, "port_bench", "configs", "tiny-cfg.json")
    cfg = bench.read_json(path)
    cfg["rig"]["supersample"] = S
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    out = bench.run_cell("tiny", 2 ** 31 + 41, 0.2, False, 0.0, root,
                         device="cpu", runner=tiny.EagerRunner,
                         log=lambda *a, **k: None)
    assert out["correct"], out["checks"]
    assert len(out["checks"]) == 5


def test_capture_stats_reports_a_supersampled_rig(tmp_path):
    """capture_stats.py's readings of its rig, cut to 27x48 and 2 views,
    on the CPU: a build, then a read of the same cache file."""
    from port_bench import capture_stats
    cfg = bench.read_json(os.path.join(bench.BENCH_DIR, "configs",
                                       f"{capture_stats.BASE}.json"))
    rig = dict(capture_stats.RIG, resy=27, resx=48, num_views=2)
    cfg = dict(cfg, rig=rig)
    first = capture_stats.stats(cfg, torch.device("cpu"), str(tmp_path))
    again = capture_stats.stats(cfg, torch.device("cpu"), str(tmp_path))
    n = rig["supersample"] ** 2 * 27 * 48
    assert first["built"] and not again["built"]
    assert first["cache_file"] == again["cache_file"] == (
        f"capture-{capture.cache_key(cfg)}.npz")
    assert first["lanes_a_view"] == n and first["chunks_a_view"] == 1
    assert first["valid_lanes"] == again["valid_lanes"] > 0
    assert first["valid_share"] == first["valid_lanes"] / (2 * n)
    assert first["views_device_bytes_by_field"]["ray_dir"] == 2 * n * 12
