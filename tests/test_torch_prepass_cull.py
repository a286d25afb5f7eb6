"""The property that the prepass kernel's cull rests on, through the plain
versions: csrc/candidates.cu's ray mode scores ray by ray only the boxes
that its tile's frustum enters (`frustum_kept_plain`), so every box that
some ray of the tile enters must be among them, or the lists would change.

Rounding is monotone, so a ray's rounded slab values lie between the tile's
rounded interval products; here that is held on the tiles a step's queries
make and on the edge cases of the arithmetic: every box with a finite
`candidate_scores_plain` score has a finite `_tile_scores` score and is
kept, at groups 1 and 4, on
- tiles of parked lanes (`_park_rays`, PARK_DIRECTION), which keep no box;
- one-origin tiles sorted by `ray_order_plain` (a silhouette query's),
  which keep a part of the mesh, at t_min 0 and past the rim;
- rays that graze box faces and edges;
- tiles whose inverse directions straddle 0 on every axis, which keep every
  valid box;
- direction components of +0, -0 and below the inverse's guard.

Last, the wrapper's `kept` argument and its counter against a recording
library. The kernel against these plain versions runs on the card:
tests/test_torch_cuda.py."""

import contextlib
import types

import numpy as np
import pytest
import torch

import drt_tpu_torch.intersect.cuda_kernel as CK
from drt_tpu_torch.mesh import build_mesh_state
from drt_tpu_torch.render.bounce import PARK_DIRECTION
from drt_tpu_torch.render.trace import _park_rays
# pytest puts tests/ on sys.path
from meshes import make_icosphere

RT = CK.RAY_TILE_INCOHERENT
RADIUS = 50.0


@pytest.fixture(scope="module")
def sphere():
    v, f = make_icosphere(subdivisions=4, radius=RADIUS)
    return build_mesh_state(v, f, device="cpu")


def _f32(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _inside(n, rng):
    """Rays from inside the sphere in every direction."""
    return (_f32(rng.uniform(-0.5, 0.5, (n, 3)) * RADIUS),
            _f32(rng.normal(size=(n, 3))))


def _prepass_inputs(ms, o, d, group, order=None):
    """(org, inv, lo, hi, valid, T) of the query as the route packs it."""
    pk = CK.pack_plain(ms.vertices, ms.faces, ms.face_valid,
                       o.float().mean(dim=0), o, d, group=group, ray_tile=RT,
                       order=order)
    return (pk.phi[6:9], pk.inv, pk.box_lo, pk.box_hi, pk.box_valid,
            pk.phi.shape[1] // RT)


def _grazing(ms, group, rng):
    """Tiles of rays lying in one box's face plane (or along its edges),
    their component across the plane +0, -0 or below the guard."""
    _, _, lo, hi, cv, _ = _prepass_inputs(ms, *_inside(RT, rng), group)
    boxes = torch.nonzero(cv).flatten().tolist()
    across = _f32([0.0, -0.0, 1e-30, -1e-30])
    org, d = [], []
    for k in range(24):
        b, a = boxes[(7 * k) % len(boxes)], k % 3
        plane = (lo if (k // 3) % 2 == 0 else hi)[b]
        c, e = (a + 1) % 3, (a + 2) % 3        # the ray runs along c
        o = torch.empty(RT, 3)
        o[:, a] = plane[a]
        o[:, c] = lo[b, c] - 10.0
        # on the box's edges, or inside its face
        ends = torch.stack([lo[b, e], hi[b, e]])
        inner = lo[b, e] + (hi[b, e] - lo[b, e]) * _f32(rng.uniform(size=RT))
        o[:, e] = torch.where(torch.arange(RT) % 2 == 0,
                              ends[torch.arange(RT) // 2 % 2], inner)
        dd = torch.empty(RT, 3)
        dd[:, a] = across[torch.arange(RT) % 4]
        dd[:, c] = 1.0
        dd[:, e] = _f32(rng.choice([0.0, -0.0, 0.01, -0.01], size=RT))
        org.append(o)
        d.append(dd)
    org, d = torch.cat(org).t().contiguous(), torch.cat(d)
    return org, CK._safe_inv(d).t().contiguous(), lo, hi, cv, 24


def _one_origin(ms, group, rng):
    """A silhouette query: one camera, rays toward the sphere's rim as the
    camera sees it, just inside and outside it, sorted along the screen;
    the last tile partly padding."""
    n = 48 * RT - 37
    cam = np.array([0.0, -3.5 * RADIUS, 0.6 * RADIUS])
    view = cam / np.linalg.norm(cam)
    u = rng.normal(size=(n, 3))
    u -= (u @ view)[:, None] * view
    rim = (u / np.linalg.norm(u, axis=1, keepdims=True) * RADIUS
           * rng.uniform(0.97, 1.03, (n, 1)))
    d = _f32(rim - cam)
    order = CK.ray_order_plain(d, -(-n // RT) * RT)
    return _prepass_inputs(ms, _f32(cam).expand(n, 3), d, group, order)


def _case(name, ms, group):
    """(org, inv, lo, hi, valid, T, t_min, parked tiles or None)."""
    rng = np.random.default_rng(23)
    t_min, parked = 0.0, None
    if name == "parked":
        # a bounce-2 query: parked lanes but for two tiles of live rays
        n = 12 * RT
        o = _park_rays(ms, torch.float32).expand(n, 3).clone()
        d = torch.full((n, 3), PARK_DIRECTION)
        live = torch.zeros(12, dtype=torch.bool)
        live[[3, 7]] = True
        lanes = live.repeat_interleave(RT)
        o[lanes], d[lanes] = _inside(2 * RT, rng)
        args = _prepass_inputs(ms, o, d, group)
        parked = ~live
    elif name in ("one-origin", "t_min"):
        args = _one_origin(ms, group, rng)
        if name == "t_min":
            # a ray's t counts lengths of d, which reaches the rim: the
            # boxes before the rim are left behind
            t_min = 1.0
    elif name == "grazing":
        args = _grazing(ms, group, rng)
    elif name == "straddle":
        args = _prepass_inputs(ms, *_inside(8 * RT, rng), group)
    else:                                       # "zeros"
        o, _ = _inside(8 * RT, rng)
        d = _f32(rng.choice([0.0, -0.0, 1e-25, -1e-25, 1.0, -1.0],
                            size=(8 * RT, 3)))
        d[::5] = _f32([1.0, -0.0, 1e-25])
        args = _prepass_inputs(ms, o, d, group)
    return (*args, t_min, parked)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("case", ["parked", "one-origin", "grazing", "t_min",
                                  "straddle", "zeros"])
def test_frustum_keeps_every_box_a_ray_enters(sphere, case, group):
    org, inv, lo, hi, cv, T, t_min, parked = _case(case, sphere, group)
    entered = torch.isfinite(CK.candidate_scores_plain(org, inv, lo, hi, cv,
                                                       T, t_min))
    frustum = torch.isfinite(CK._tile_scores(
        org.reshape(3, T, RT).permute(1, 0, 2),
        inv.reshape(3, T, RT).permute(1, 0, 2), lo, hi, cv, t_min))
    kept = CK.frustum_kept_plain(org, inv, lo, hi, cv, T, t_min)
    assert bool(entered.any())
    assert not bool((entered & ~frustum).any())
    assert not bool((entered & ~kept).any())
    assert not bool((kept & ~cv[None]).any())
    straddles = CK.tile_straddles(inv, T)
    n_valid = int(cv.sum())
    if case == "parked":
        assert int(kept[parked].sum()) == 0 and bool(kept[~parked].any())
    if case == "straddle":
        assert bool(straddles.all())
        assert kept.sum(dim=1).tolist() == [n_valid] * T
    if case in ("one-origin", "t_min"):
        # sorted cones: the cull leaves out most of the valid boxes
        assert not bool(straddles.any())
        assert int(kept.sum()) < T * n_valid * 0.6
    # the list the kernel sorts over its kept boxes is the plain one
    score = CK.candidate_scores_plain(org, inv, lo, hi, cv, T, t_min)
    culled = torch.where(kept, score, float("inf"))
    for got, want in zip(CK._sorted_candidates(culled),
                         CK.candidates_plain(org, inv, lo, hi, cv, T,
                                             tile=False, t_min=t_min)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("with_kept", [False, True])
@pytest.mark.parametrize("mode", ["ray", "tile"])
def test_wrapper_counts_ray_mode_and_passes_kept(monkeypatch, mode,
                                                 with_kept):
    """`candidates_cuda` against a recording library: `kept` goes out as
    its pointer (NULL where not given, as in the step), and the ray mode's
    launch counts in `prepass_cull_launches` as well, the tile mode's only
    in `candidates_launches`; a `kept` of the wrong size is refused."""
    from drt_tpu_torch import kernels
    calls = []
    lib = types.SimpleNamespace(candidates_launch=lambda *a: calls.append(a)
                                or 0)
    monkeypatch.setattr(kernels, "library", lambda name: lib)
    monkeypatch.setattr(kernels, "need_cuda", lambda what, t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=5))
    T, NC = 3, 7
    args = (torch.zeros(3, T * RT), torch.ones(3, T * RT), torch.zeros(NC, 3),
            torch.ones(NC, 3), torch.ones(NC, dtype=torch.bool), T)
    kept = torch.zeros(T, dtype=torch.int32) if with_kept else None
    before = kernels.counters.snapshot()
    CK.candidates_cuda(*args, tile=mode == "tile", kept=kept)
    after = kernels.counters.snapshot()
    (got,), names = calls, kernels.ROWS["candidates"][0]
    assert dict(zip(names, got))["kept"] == (
        kept.data_ptr() if with_kept else None)
    assert after["candidates_launches"] == before["candidates_launches"] + 1
    assert after["prepass_cull_launches"] == (
        before["prepass_cull_launches"] + (mode == "ray"))
    with pytest.raises(ValueError, match="kept"):
        CK.candidates_cuda(*args, tile=False,
                           kept=torch.zeros(T + 1, dtype=torch.int32))
    assert len(calls) == 1
