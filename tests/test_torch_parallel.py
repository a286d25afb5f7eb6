"""drt_tpu_torch.parallel in two real gloo processes on the CPU, against
the single-process port step and against drt_tpu's sharded step on 2 of the
8 virtual CPU devices, in float64 with the compat chain (the inputs of
tests/test_torch_train.py, carried across with drt_tpu_torch.convert).

One module-scoped spawn runs every case: both ranks run
tests/torch_parallel_worker.py (which imports only torch and
drt_tpu_torch), join through a file:// address in a temporary directory,
and write their results as .npz; each test below reads one case. The cases
are those tests/test_parallel.py holds the JAX package to: the sharded step
(2 sgd steps), a ray count that does not divide (15x17, padded), the
uadam + h1 evidence path, the oracle split over the ranks (brute, culled and
the resorted route), the shard shapes, `shard_rays_for_host` and
`init_multihost`."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drt_tpu.data.synthetic import synthesize_capture as j_synth
from drt_tpu.data.views import ViewBatch as JViews
from drt_tpu.intersect import get_intersect_fn as j_get_fn
from drt_tpu.optimize.losses import LossWeights as JW
from drt_tpu.parallel import make_ray_mesh as j_make_ray_mesh
from drt_tpu.parallel import make_sharded_train_step as j_sharded_step
from drt_tpu.parallel import pad_views_to_multiple as j_pad
from drt_tpu_torch.convert import mesh_state_from_arrays, view_batch_from_arrays
from drt_tpu_torch.intersect import get_intersect_fn as t_get_fn
from drt_tpu_torch.intersect import intersect_brute
from drt_tpu_torch.optimize import (LossWeights, default_silhouette_budget,
                                    make_train_step)
from drt_tpu_torch.parallel import multihost, pad_views_to_multiple
from drt_tpu_torch.parallel.sharding import RayMesh, shard_views
from tests.meshes import make_icosphere
from tests.test_culled import scene_rays
from tests.test_torch_train import (HP, RAY_VIEWS, RES, SILH, _jax_state,
                                    _weights, setup)  # noqa: F401

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RES_B = (15, 17)               # 255 rays a view: does not divide over 2
H1 = dict(precond_lambda=9.0, cg_iters=64)


def _close(t, j, what):
    j = np.asarray(j, np.float64)
    np.testing.assert_allclose(np.asarray(t, np.float64), j, rtol=1e-7,
                               atol=1e-7 * max(np.abs(j).max(), 1e-300),
                               err_msg=what)


@pytest.fixture(scope="module")
def views_b():
    """The 15x17 capture of tests/test_torch_train.py's sphere."""
    gt_v, gt_f = make_icosphere(subdivisions=3, radius=20.0)
    cap = j_synth(gt_v, gt_f, num_views=4, resy=RES_B[0], resx=RES_B[1],
                  backend="brute")
    views = {k: np.asarray(getattr(cap.views, k), np.float64)
             for k in JViews._fields}
    views["valid"] = np.asarray(cap.views.valid)
    return views


@pytest.fixture(scope="module")
def ranks(setup, views_b, tmp_path_factory):  # noqa: F811
    """Spawn both ranks once; their results, [rank0, rank1]."""
    views, mesh = setup
    work = str(tmp_path_factory.mktemp("torch_parallel"))
    so, sd = scene_rays(1024, seed=5)
    arrs = {"scene_o": np.asarray(so), "scene_d": np.asarray(sd)}
    arrs.update({f"M_{k}": np.asarray(v) for k, v in mesh.items()})
    arrs.update({f"A_{k}": v for k, v in views.items()})
    arrs.update({f"B_{k}": v for k, v in views_b.items()})
    np.savez(os.path.join(work, "inputs.npz"), **arrs)
    w = _weights(LossWeights)
    with open(os.path.join(work, "config.json"), "w") as fh:
        json.dump({"weights": w._asdict(), "lr": HP.start_lr,
                   "budget": default_silhouette_budget(mesh["num_edges"]),
                   "res_a": RES, "res_b": RES_B, "ray_views": RAY_VIEWS,
                   "silh": SILH, "h1": H1}, fh)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_parallel_worker.py"),
         str(r), str(WORLD), work],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [dict(np.load(os.path.join(work, f"rank{r}.npz")))
            for r in range(WORLD)]


def _port_single(setup, views, res, ray_views, backend="auto",  # noqa: F811
                 **kw):
    """The single-process port step: (losses, vertices, params, aux)."""
    _, mesh = setup
    tms = mesh_state_from_arrays(mesh, "cpu")
    tv = view_batch_from_arrays(views, "cpu")
    init, step, final = make_train_step(
        t_get_fn(backend), _weights(LossWeights), *res,
        default_silhouette_budget(mesh["num_edges"]), **kw)
    st = init(tms)
    losses = []
    for i in ray_views:
        st, loss, aux = step(st, HP.start_lr, tms, tv, i, SILH)
        losses.append(float(loss))
    return losses, final(st, tms).numpy(), st["params"].numpy(), aux


def _jax_sharded(setup, views, res, ray_views, pad=False, **kw):  # noqa: F811
    """drt_tpu's make_sharded_train_step on 2 virtual CPU devices:
    (losses, vertices, aux)."""
    _, mesh = setup
    with jax.enable_x64(True):
        jv, jms = _jax_state(views, mesh)
        if pad:
            jv = j_pad(jv, WORLD)
        (init, step, final), ms_s, views_s = j_sharded_step(
            dict(intersect_fn=j_get_fn("brute"), weights=_weights(JW),
                 resy=res[0], resx=res[1],
                 silhouette_budget=default_silhouette_budget(
                     mesh["num_edges"]), **kw),
            j_make_ray_mesh(jax.devices()[:WORLD]), jms, jv)
        st = init(ms_s)
        losses = []
        for i in ray_views:
            st, loss, aux = step(st, jnp.asarray(HP.start_lr, jnp.float64),
                                 ms_s, views_s, jnp.asarray([i]),
                                 jnp.asarray(SILH))
            losses.append(float(loss))
        return (losses, np.asarray(final(st, ms_s)),
                {k: np.asarray(v) for k, v in aux.items()})


def _ranks_agree(ranks, name):
    """Both ranks applied the same update: their results are equal."""
    for k in ranks[0]:
        if k.startswith(name + "_"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k],
                                          err_msg=k)


def test_sharded_step_matches_single_port_step(setup, ranks):  # noqa: F811
    views, _ = setup
    _ranks_agree(ranks, "train")
    r = ranks[0]
    losses, verts, params, aux = _port_single(setup, views, RES, RAY_VIEWS)
    assert np.abs(params).max() > 1e-3              # the steps moved it
    _close(r["train_losses"], losses, "losses")
    _close(r["train_verts"], verts, "vertices")
    for k in ("ray", "vh", "sm"):
        _close(r[f"train_aux_{k}"], aux[k].numpy(), k)
    # The counters are summed and the silhouette-edge count is the largest.
    # A lane that dies either way may die at another query: a rank's
    # incoherent queries shift the scene by its own rays' mean origin, and
    # compat's absolute exit nudge leaves grazing exits within a few float32
    # ulps of their surface (tests/test_torch_train.py).
    for k in ("valid_rays", "active_after_bounce1", "silh_edge_max"):
        assert int(r[f"train_aux_{k}"]) == int(aux[k]), k
    # each rank: 3 ray queries and its 2 of the 4 silhouette views a step
    assert r["train_calls"].tolist() == [3 + len(SILH) // WORLD] * 2


def test_sharded_step_matches_jax_sharded_step(setup, ranks):  # noqa: F811
    views, _ = setup
    losses, verts, _ = _jax_sharded(setup, views, RES, RAY_VIEWS)
    _close(ranks[0]["train_losses"], losses, "losses")
    _close(ranks[0]["train_verts"], verts, "vertices")


def test_nondivisible_rays_pad_then_shard(setup, views_b, ranks):  # noqa: F811
    """The brute oracle on both sides, as in tests/test_parallel.py. The
    cuda backend shifts each query by its rays' mean origin, and the parked
    padding lanes move that mean: at 15x17 one bounce-2 ray of step 2 lies
    within float32 rounding of a shared edge, and the shift alone flips it
    (the unpadded single step against the padded one: 1 bounce-2 and 2
    exit rays, loss 2.3% apart; with brute they agree)."""
    _ranks_agree(ranks, "padded")
    r = ranks[0]
    assert int(r["padded_n"]) == 256
    losses, verts, _, _ = _port_single(setup, views_b, RES_B, RAY_VIEWS,
                                       backend="brute")
    _close(r["padded_losses"], losses, "losses against the port")
    _close(r["padded_verts"], verts, "vertices against the port")
    jlosses, jverts, _ = _jax_sharded(setup, views_b, RES_B, RAY_VIEWS,
                                      pad=True)
    _close(r["padded_losses"], jlosses, "losses against drt_tpu")
    _close(r["padded_verts"], jverts, "vertices against drt_tpu")


def test_uneven_split_raises(views_b):
    tv = view_batch_from_arrays(views_b, "cpu")
    mesh = RayMesh(None, 0, WORLD, torch.device("cpu"))
    with pytest.raises(ValueError, match="pad the ray batch"):
        shard_views(mesh, tv)
    padded = pad_views_to_multiple(tv, WORLD)
    assert padded.ray_dir.shape[1] == 256
    assert not bool(padded.valid[:, 255:].any())
    np.testing.assert_array_equal(padded.ray_dir[:, 255].numpy(),
                                  tv.ray_dir[:, 254].numpy())
    assert shard_views(mesh, padded).ray_dir.shape == (4, 128, 3)


def test_pad_views_noop_when_divisible(setup):  # noqa: F811
    tv = view_batch_from_arrays(setup[0], "cpu")
    assert pad_views_to_multiple(tv, 8) is tv


def test_h1_evidence_path_matches_single(setup, ranks):  # noqa: F811
    views, _ = setup
    _ranks_agree(ranks, "h1")
    r = ranks[0]
    losses, verts, _, aux = _port_single(setup, views, RES, RAY_VIEWS[:1],
                                         optimizer="uadam", precond="h1",
                                         **H1)
    _close(r["h1_losses"], losses, "loss")
    np.testing.assert_allclose(float(r["h1_aux_evidence_mean"]),
                               float(aux["evidence_mean"]), rtol=1e-7)
    _close(r["h1_verts"], verts, "vertices against the port")
    jlosses, jverts, jaux = _jax_sharded(setup, views, RES, RAY_VIEWS[:1],
                                         optimizer="uadam", precond="h1",
                                         **H1)
    _close(r["h1_losses"], jlosses, "loss against drt_tpu")
    np.testing.assert_allclose(float(r["h1_aux_evidence_mean"]),
                               float(jaux["evidence_mean"]), rtol=1e-7)
    _close(r["h1_verts"], jverts, "vertices against drt_tpu")


@pytest.mark.parametrize("backend", ["brute", "culled"])
def test_shard_mapped_intersect_matches_direct(setup, ranks, backend):  # noqa: F811
    views, mesh = setup
    tms = mesh_state_from_arrays(mesh, "cpu")
    tv = view_batch_from_arrays(views, "cpu")
    o = tv.origin[0].expand(tv.ray_dir[0].shape)
    h = t_get_fn(backend)(o, tv.ray_dir[0], tms.vertices, tms.faces,
                          tms.face_valid, coherent=True)
    for r in ranks:
        assert (r[f"{backend}_tri_id"] >= 0).sum() > 20
        np.testing.assert_array_equal(r[f"{backend}_tri_id"],
                                      h.tri_id.numpy())
        np.testing.assert_allclose(r[f"{backend}_t"], h.t.numpy(),
                                   rtol=1e-6)


def test_shard_mapped_resort_oracle_matches_brute(setup, ranks):  # noqa: F811
    _, mesh = setup
    tms = mesh_state_from_arrays(mesh, "cpu")
    o, d = (torch.tensor(np.asarray(a)) for a in scene_rays(1024, seed=5))
    hb = intersect_brute(o, d, tms.vertices, tms.faces, tms.face_valid)
    both = hb.hit.numpy()
    assert both.sum() > 50
    for r in ranks:
        np.testing.assert_array_equal(r["resort_tri_id"] >= 0, both)
        np.testing.assert_allclose(r["resort_t"][both], hb.t.numpy()[both],
                                   rtol=1e-5, atol=1e-4)


def test_ray_arrays_actually_sharded(setup, ranks):  # noqa: F811
    views, _ = setup
    n = RES[0] * RES[1]
    for rank, r in enumerate(ranks):
        assert r["shape_ray_dir"].tolist() == [4, n // WORLD, 3]
        assert r["shape_screen_pixel"].tolist() == [4, n // WORLD, 3]
        assert r["shape_valid"].tolist() == [4, n // WORLD]
        assert r["shape_origin"].tolist() == [4, 1, 3]      # compact: whole
        assert r["shape_mask"].tolist() == [4, *RES]
        assert r["shape_K"].tolist() == [4, 3, 3]
        sl = slice(rank * n // WORLD, (rank + 1) * n // WORLD)
        np.testing.assert_array_equal(r["shard_ray_dir"],
                                      views["ray_dir"][:, sl])
        assert r["host_slice"].tolist() == [sl.start, sl.stop]


def test_replicate_gives_rank0_bits(setup, ranks):  # noqa: F811
    _, mesh = setup
    for r in ranks:
        np.testing.assert_array_equal(r["replicated"], mesh["vertices"])
        np.testing.assert_array_equal(r["replicated_v"], mesh["vertices"])


def test_shard_rays_for_host_rejects_uneven(monkeypatch):
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 3)
    with pytest.raises(ValueError, match="pad the ray batch"):
        multihost.shard_rays_for_host(255)
    assert multihost.shard_rays_for_host(256) == slice(192, 256)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    assert multihost.shard_rays_for_host(256) == slice(0, 64)


def test_init_multihost_cuda_raises_without_card(monkeypatch):
    """No fallback to gloo on the CPU when the card is missing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.init_multihost("localhost:1", 1, 0, device="cuda")
    assert not torch.distributed.is_initialized()
