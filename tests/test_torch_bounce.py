"""A bounce's per-lane chain and the ray loss's per-lane tail
(drt_tpu_torch/render/bounce.py, whose CUDA kernels are csrc/bounce.cu)
against the JAX package on the CPU.

The plain versions are what the kernels compute: their forward and their
hand-written backward are held to the JAX functions they restate
(`moller_trumbore_verts`, `refract_ray`, `_park_rays`'s parking, the ray
loss's tail) and their `jax.vjp`, with the oracle replaced by fixed hits in
both packages, and to torch autograd of the port's own chain of those
functions. Tolerances: float64 rtol 1e-12 (with an atol of 1e-12 of the
largest entry, for entries that cancel to near zero), float32 within 1e-5
of the largest entry; masks and face ids equal. The lanes include misses,
total internal reflection, degenerate triangles (|det| <= 1e-12), cos_i =
+-1 exactly (the clamps' ties, where the cotangent splits in halves), dead
lanes to park, compat on and off, Huber 0 and 0.1, float32 and float64."""

import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.geometry.mt as JMT
import drt_tpu.geometry.vec as JVEC
import drt_tpu.mesh as JMESH
import drt_tpu.render.trace as JT
from drt_tpu.intersect import get_intersect_fn as j_get_fn
from drt_tpu.optimize.losses import ray_loss as j_ray_loss
from drt_tpu_torch import kernels
from drt_tpu_torch.geometry.mt import moller_trumbore_verts
from drt_tpu_torch.intersect import get_intersect_fn as t_get_fn
from drt_tpu_torch.mesh import build_mesh_state
from drt_tpu_torch.optimize.losses import ray_loss as t_ray_loss
from drt_tpu_torch.intersect import cuda_kernel as CK
from drt_tpu_torch.optimize import precondition as TP
from drt_tpu_torch.render import bounce as TB
from drt_tpu_torch.render import silhouette_kernels as SK
from drt_tpu_torch.render import trace as TT
from tests.meshes import make_icosphere

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

IOR, EXT, EPS = 1.4723, 1.00029, 1e-5
DTYPES = {"float32": (torch.float32, np.float32),
          "float64": (torch.float64, np.float64)}


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _sphere(seed):
    """A 20-unit icosphere turned at random (its edges off the coordinate
    planes), float64 numpy."""
    rng = np.random.default_rng(seed)
    v, f = make_icosphere(subdivisions=2, radius=20.0)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return v @ q.T, f


def _case(np_dtype, seed=0, n_cam=1200, n_in=1200):
    """Inputs of the chain after the oracle, from a numpy seed: camera-like
    rays at the sphere (hits and misses, entering), interior rays (exiting,
    many totally reflected), with their hits from the port's brute oracle;
    then 6 lanes with |det| <= 1e-12 and 4 at cos_i = +-1 exactly (a
    triangle in z = 0 and rays along z), all hit; every tenth lane dead.
    Returns a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    v, f = _sphere(seed)
    o1 = _unit(rng.normal(size=(n_cam, 3))) * 60.0
    d1 = _unit(rng.normal(size=(n_cam, 3)) * 14.0 - o1)
    o2 = (_unit(rng.normal(size=(n_in, 3)))
          * rng.uniform(10.0, 19.0, (n_in, 1)))
    d2 = _unit(rng.normal(size=(n_in, 3)))
    origin = np.concatenate([o1, o2]).astype(np_dtype)
    direction = np.concatenate([d1, d2]).astype(np_dtype)
    tdt = torch.float64 if np_dtype == np.float64 else torch.float32
    ms = build_mesh_state(v, f, dtype=tdt, device="cpu")
    hits = t_get_fn("brute")(torch.from_numpy(origin),
                             torch.from_numpy(direction), ms.vertices,
                             ms.faces, ms.face_valid, coherent=False)
    hit = hits.hit.numpy().copy()
    safe_id = np.where(hit, hits.tri_id.numpy(), 0).astype(np.int64)
    vert = ms.vertices.numpy()
    g9 = vert[ms.faces.numpy()[safe_id]].reshape(-1, 9)
    # |det| <= 1e-12 (all hit): 2 triangles shrunk to a point, 2 rays in
    # the plane of their triangle, 2 triangles of 1e-7 edges (a normal of
    # its own, the guard's det: these lanes live)
    flat = np.array([0, 0, 0, 1, 0, 0, 0, 1, 0], np.float64)
    deg = np.concatenate([np.tile(rng.normal(size=(2, 3)) * 10.0, 3),
                          np.tile(flat, (2, 1)), np.tile(flat * 1e-7, (2, 1))])
    o_deg = np.concatenate([rng.normal(size=(2, 3)) * 30.0,
                            [[-3.0, 0.2, 0.0], [0.2, -3.0, 0.0]],
                            [[0.2, 0.3, 5.0], [0.1, 0.3, 4.0]]])
    d_deg = np.concatenate([_unit(rng.normal(size=(2, 3))),
                            [[1.0, 0, 0], [0, 1.0, 0]],
                            [[0, 0, -1.0], [0, 0, -1.0]]])
    # cos_i = +-1: the flat triangle, normal +z, rays along z
    flat = np.tile(flat, (4, 1))
    o_flat = np.array([[0.2, 0.3, 5.0], [0.1, 0.1, -5.0],
                       [0.3, 0.2, 7.0], [0.25, 0.25, -2.0]])
    d_flat = np.array([[0, 0, -1.0], [0, 0, 1.0], [0, 0, -1.0],
                       [0, 0, 1.0]])
    origin = np.concatenate([origin, o_deg, o_flat]).astype(np_dtype)
    direction = np.concatenate([direction, d_deg, d_flat]).astype(np_dtype)
    g9 = np.concatenate([g9, deg, flat]).astype(np_dtype)
    hit = np.concatenate([hit, np.ones(10, bool)])
    safe_id = np.concatenate([safe_id, np.arange(10, dtype=np.int64) + 3])
    n = origin.shape[0]
    active = np.arange(n) % 10 != 7
    active[-10:] = True
    park = (vert.min(0) - (vert.max(0) - vert.min(0)) - 1.0).astype(np_dtype)
    return dict(origin=origin, direction=direction, g9=g9, hit=hit,
                active=active, safe_id=safe_id, park=park)


def _torch(c):
    return {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in c.items()}


def _j_chain(o, d, g9, hit, active, safe_id, park, compat):
    """The JAX package's `_bounce` after its oracle query
    (drt_tpu/render/trace.py:241-260), with its parked ray."""
    _u, _v, t, n = JMT.moller_trumbore_verts(o, d, g9[:, 0:3], g9[:, 3:6],
                                             g9[:, 6:9])
    t = jnp.where(hit, t, 1.0)
    refracted, new_o, new_d = JT.refract_ray(o, d, t, n, IOR, EXT, EPS,
                                             compat=compat)
    act = active & hit & refracted
    m = act[:, None]
    park_d = jnp.full((3,), -0.57735027, d.dtype)
    return (jnp.where(m, jnp.where(m, new_o, o), park.astype(o.dtype)),
            jnp.where(m, jnp.where(m, new_d, d), park_d), act,
            jnp.where(act, safe_id, 0))


def _t_chain(o, d, g9, hit, active, safe_id, park, compat):
    """The port's chain of its torch functions, as `_bounce` ran it before
    csrc/bounce.cu (autograd through every operation)."""
    _u, _v, t, n = moller_trumbore_verts(o, d, g9[:, 0:3], g9[:, 3:6],
                                         g9[:, 6:9])
    t = torch.where(hit, t, torch.ones_like(t))
    refracted, new_o, new_d = TT.refract_ray(o, d, t, n, IOR, EXT, EPS,
                                             compat=compat)
    act = active & hit & refracted
    m = act[:, None]
    park_d = torch.full((3,), -0.57735027, dtype=d.dtype)
    return (torch.where(m, torch.where(m, new_o, o), park),
            torch.where(m, torch.where(m, new_d, d), park_d), act,
            torch.where(act, safe_id, torch.zeros_like(safe_id)))


def _close(got, want, np_dtype, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    if np_dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                                   err_msg=what)


def _jax(np_dtype, fn):
    """Run fn with JAX's float64 switched on for float64 inputs."""
    if np_dtype == np.float64:
        with jax.enable_x64(True):
            return jax.tree_util.tree_map(np.asarray, fn())
    return jax.tree_util.tree_map(np.asarray, fn())


def _j_inputs(c):
    return (jnp.asarray(c["origin"]), jnp.asarray(c["direction"]),
            jnp.asarray(c["g9"]), jnp.asarray(c["hit"]),
            jnp.asarray(c["active"]), jnp.asarray(c["safe_id"]),
            jnp.asarray(c["park"]))


def _cotangents(c, seed=5):
    rng = np.random.default_rng(seed)
    n = c["origin"].shape[0]
    dt = c["origin"].dtype
    return (rng.normal(size=(n, 3)).astype(dt),
            rng.normal(size=(n, 3)).astype(dt))


def test_case_has_every_kind_of_lane():
    """The inputs hold misses, total internal reflection, degenerate
    triangles, cos_i = +-1 exactly and dead lanes."""
    c = _case(np.float64)
    t = _torch(c)
    _, _, alive, _ = TB.bounce_plain(t["origin"], t["direction"], t["g9"],
                                     t["hit"], t["active"], t["safe_id"],
                                     t["park"], IOR, EXT, EPS)
    live = t["hit"] & t["active"]
    assert int((~t["hit"]).sum()) > 100                  # misses
    assert int((live & ~alive).sum()) > 100              # TIR (and det 0)
    assert int((~t["active"]).sum()) > 100               # dead
    k = TB._Consts(t["origin"], IOR, EXT, EPS)
    L = TB._lane_forward(TB._cols(t["origin"]), TB._cols(t["direction"]),
                         TB._cols(t["g9"]), k, False)
    assert int((~L["ok"]).sum()) >= 6                    # |det| <= 1e-12
    assert bool(alive[-6:-4].all())                      # ... and live
    wo_n = TB._dot(tuple(-x for x in TB._cols(t["direction"])), L["n"])
    assert int((wo_n == 1.0).sum()) == 2 and int((wo_n == -1.0).sum()) == 2
    assert bool(alive[-4:].all())                        # the ties live


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_forward_matches_jax(dtype, compat):
    tdt, ndt = DTYPES[dtype]
    c = _case(ndt)
    t = _torch(c)
    got = TB.bounce_plain(t["origin"], t["direction"], t["g9"], t["hit"],
                          t["active"], t["safe_id"], t["park"], IOR, EXT,
                          EPS, compat=compat)
    want = _jax(ndt, lambda: _j_chain(*_j_inputs(c), compat))
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    _close(got[0].numpy(), want[0], ndt, "o_out")
    _close(got[1].numpy(), want[1], ndt, "d_out")
    assert got[0].dtype == tdt and got[3].dtype == torch.int64


@pytest.mark.parametrize("which", ["d_out", "both"])
@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_backward_matches_jax_vjp(dtype, compat, which):
    """Cotangents on d_out alone (the ray loss's case: it detaches the exit
    origin) and on both outputs, against jax.vjp of the JAX chain."""
    _, ndt = DTYPES[dtype]
    c = _case(ndt, seed=1)
    t = _torch(c)
    go, gd = _cotangents(c)
    if which == "d_out":
        go = np.zeros_like(go)

    def vjp():
        o, d, g9, hit, active, safe_id, park = _j_inputs(c)
        _, f = jax.vjp(lambda o, d, g9: _j_chain(o, d, g9, hit, active,
                                                 safe_id, park, compat)[:2],
                       o, d, g9)
        return f((jnp.asarray(go), jnp.asarray(gd)))
    want = _jax(ndt, vjp)
    alive = TB.bounce_plain(t["origin"], t["direction"], t["g9"], t["hit"],
                            t["active"], t["safe_id"], t["park"], IOR, EXT,
                            EPS, compat=compat)[2]
    d_o, d_d, dg9 = TB.bounce_plain_backward(
        t["origin"], t["direction"], t["g9"], alive,
        None if which == "d_out" else torch.from_numpy(go),
        torch.from_numpy(gd), IOR, EXT, EPS, compat=compat)
    if which == "d_out":
        assert d_o is None
        assert not np.abs(want[0]).any()
    else:
        _close(d_o.numpy(), want[0], ndt, "d_origin")
    _close(d_d.numpy(), want[1], ndt, "d_direction")
    _close(dg9.numpy(), want[2], ndt, "dg9")


@pytest.mark.parametrize("which", ["d_out", "o_out", "both"])
@pytest.mark.parametrize("compat", [False, True])
def test_plain_backward_matches_torch_autograd(compat, which):
    """Float64: the hand-written backward against torch autograd of the
    port's `moller_trumbore_verts` and `refract_ray` chain."""
    c = _case(np.float64, seed=2)
    t = _torch(c)
    go, gd = (torch.from_numpy(a) for a in _cotangents(c, seed=6))
    leaves = [t[k].clone().requires_grad_(True)
              for k in ("origin", "direction", "g9")]
    o_out, d_out, _, _ = _t_chain(*leaves, t["hit"], t["active"],
                                  t["safe_id"], t["park"], compat)
    outs, cots = [], []
    if which != "d_out":
        outs.append(o_out)
        cots.append(go)
    if which != "o_out":
        outs.append(d_out)
        cots.append(gd)
    want = torch.autograd.grad(outs, leaves, cots, allow_unused=True)
    alive = TB.bounce_plain(t["origin"], t["direction"], t["g9"], t["hit"],
                            t["active"], t["safe_id"], t["park"], IOR, EXT,
                            EPS, compat=compat)[2]
    got = TB.bounce_plain_backward(
        t["origin"], t["direction"], t["g9"], alive,
        go if which != "d_out" else None, gd if which != "o_out" else None,
        IOR, EXT, EPS, compat=compat)
    for name, g, w in zip(("d_origin", "d_direction", "dg9"), got, want):
        if g is None:           # the new direction does not read the origin
            assert name == "d_origin" and which == "d_out" and w is None
        else:
            _close(g.numpy(), w.numpy(), np.float64, name)


def test_plain_forward_matches_the_ports_torch_chain():
    """Float64: the same lanes live and die, the same rays."""
    c = _case(np.float64, seed=3)
    t = _torch(c)
    args = (t["origin"], t["direction"], t["g9"], t["hit"], t["active"],
            t["safe_id"], t["park"])
    got = TB.bounce_plain(*args, IOR, EXT, EPS)
    want = _t_chain(*args, False)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    for g, w in zip(got[:2], want[:2]):
        _close(g.numpy(), w.numpy(), np.float64, "rays")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bounce_chain_function_on_cpu_takes_the_plain_versions(dtype,
                                                               monkeypatch):
    """The autograd Function on CPU tensors: the plain versions' bits,
    forward and backward, no kernel launch, and no cotangent for the
    origin where the new origin is unused."""
    tdt, ndt = DTYPES[dtype]
    c = _case(ndt, seed=4)
    t = _torch(c)

    def no_kernel(*a, **k):
        raise AssertionError("a kernel's wrapper called on CPU tensors")
    for name in ("bounce_cuda", "bounce_cuda_backward"):
        monkeypatch.setattr(TB, name, no_kernel)
    before = kernels.counters.snapshot()
    leaves = [t[k].clone().requires_grad_(True)
              for k in ("origin", "direction", "g9")]
    o_out, d_out, alive, tri = TB.bounce_chain(
        *leaves, t["hit"], t["active"], t["safe_id"], t["park"], IOR, EXT,
        EPS)
    want = TB.bounce_plain(t["origin"], t["direction"], t["g9"], t["hit"],
                           t["active"], t["safe_id"], t["park"], IOR, EXT,
                           EPS)
    for g, w in zip((o_out, d_out, alive, tri), want):
        assert torch.equal(g, w)
    assert not alive.requires_grad and not tri.requires_grad
    _, gd = (torch.from_numpy(a) for a in _cotangents(c))
    grads = torch.autograd.grad(d_out, leaves, gd, allow_unused=True)
    w_d = TB.bounce_plain_backward(t["origin"], t["direction"], t["g9"],
                                   alive, None, gd, IOR, EXT, EPS)
    assert grads[0] is None
    assert torch.equal(grads[1], w_d[1]) and torch.equal(grads[2], w_d[2])
    assert kernels.counters.snapshot() == before


def _tail_case(np_dtype, seed=0, n=3000):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 5.0).astype(np_dtype)
    d = _unit(rng.normal(size=(n, 3))).astype(np_dtype)
    sp = (rng.normal(size=(n, 3)) * 40.0).astype(np_dtype)
    sp[:5] = o[:5]                  # target from a zero vector: guarded
    near = _unit(sp[5:10] - o[5:10]).astype(np_dtype)
    d[5:10] = near                  # s = 0 (or nearly): the Huber floor
    return dict(origin=o, direction=d, screen_pixel=sp,
                lane_valid=rng.uniform(size=n) > 0.1,
                active=rng.uniform(size=n) > 0.3,
                exit_hit=rng.uniform(size=n) > 0.8)


def _j_tail(o, d, sp, lane_valid, active, exit_hit, huber):
    """The JAX package's ray loss after its trace: render_transparent's
    zeroing (drt_tpu/render/trace.py:317-322) and the body of `ray_loss`
    (drt_tpu/optimize/losses.py:88-105)."""
    valid = active & jnp.logical_not(exit_hit)
    m = valid[..., None]
    o, d = jnp.where(m, o, 0.0), jnp.where(m, d, 0.0)
    target = JVEC.safe_normalize(sp - jax.lax.stop_gradient(o))
    diff = d - target
    w = lane_valid & valid
    s = jnp.sum(jnp.where(w[:, None], diff * diff, 0.0), axis=1)
    if huber:
        r = jnp.sqrt(jnp.maximum(s, 1e-24))
        s = jnp.where(r <= huber, s, 2.0 * huber * r - huber * huber)
    return jnp.sum(jnp.where(w, s, 0.0))


@pytest.mark.parametrize("huber", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ray_tail_matches_jax_value_and_gradient(dtype, huber, monkeypatch):
    """`ray_tail` (the Function, on the CPU the plain versions) against the
    JAX tail: the loss and its gradient in the exit directions."""
    tdt, ndt = DTYPES[dtype]
    c = _tail_case(ndt)
    t = _torch(c)

    def no_kernel(*a, **k):
        raise AssertionError("a kernel's wrapper called on CPU tensors")
    for name in ("ray_tail_cuda", "ray_tail_cuda_backward"):
        monkeypatch.setattr(TB, name, no_kernel)
    d = t["direction"].clone().requires_grad_(True)
    loss = TB.ray_tail(t["origin"], d, t["screen_pixel"], t["lane_valid"],
                       t["active"], t["exit_hit"], huber)
    (g,) = torch.autograd.grad(loss * 3.0, d)

    def ref():
        args = [jnp.asarray(c[k]) for k in ("origin", "direction",
                                            "screen_pixel", "lane_valid",
                                            "active", "exit_hit")]

        def f(dd):
            return _j_tail(args[0], dd, *args[2:], huber)
        return f(args[1]), jax.grad(lambda dd: 3.0 * f(dd))(args[1])
    want_l, want_g = _jax(ndt, ref)
    assert loss.dtype == tdt and loss.shape == ()
    rtol = 1e-12 if ndt == np.float64 else 1e-5
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=rtol)
    _close(g.numpy(), want_g, ndt, "d_direction")
    if huber:                       # lanes on both sides of the branch
        _, _, r = TB._tail_lanes(t["origin"], t["direction"],
                                 t["screen_pixel"], TB._Consts(d), huber)
        w = t["lane_valid"] & t["active"] & ~t["exit_hit"]
        assert int((w & (r <= huber)).sum()) >= 3
        assert int((w & (r > huber)).sum()) > 100


def test_tail_sum_is_the_kernel_order():
    """`tail_sum` against a numpy statement of csrc/bounce.cu's order:
    thread j adds lanes j, j + G, ... from +0, then the halving trees over
    a block's threads and over the blocks."""
    rng = np.random.default_rng(9)
    for n in (0, 1, 1000, TB.RAY_TAIL_THREADS + 17):
        x = rng.normal(size=n).astype(np.float32)
        acc = np.zeros(TB.RAY_TAIL_THREADS, np.float32)
        for i in range(0, n, TB.RAY_TAIL_THREADS):
            row = x[i:i + TB.RAY_TAIL_THREADS]
            acc[:row.size] = acc[:row.size] + row
        acc = acc.reshape(TB.RAY_TAIL_BLOCKS, TB.RAY_TAIL_BLOCK)
        for axis in (1, 0):
            while acc.shape[axis] > 1:
                h = acc.shape[axis] // 2
                acc = (np.take(acc, range(h), axis=axis)
                       + np.take(acc, range(h, 2 * h), axis=axis))
        got = TB.tail_sum(torch.from_numpy(x))
        assert got.numpy().view(np.int32) == acc.reshape(()).view(np.int32)
        np.testing.assert_allclose(float(got), float(x.sum(dtype=np.float64)),
                                   rtol=1e-4, atol=1e-4)


def _loss_setup(seed=11, res=(14, 18)):
    """A float64 view of the turned icosphere: camera rays, random matted
    screen points and validity, as a 6-tuple both packages' ray_loss
    unpack."""
    rng = np.random.default_rng(seed)
    v, f = _sphere(seed)
    v = v * np.clip(1 + 0.05 * rng.standard_normal(len(v))[:, None], 0.9,
                    1.1)
    n = res[0] * res[1]
    o = np.tile(np.array([[3.0, -4.0, 80.0]]), (n, 1))
    px = rng.uniform(-14.0, 14.0, size=(n, 2))
    d = _unit(np.concatenate([px, np.zeros((n, 1))], axis=1) - o)
    sp = rng.normal(size=(n, 3)) * 30.0 + np.array([0.0, 0.0, -90.0])
    valid = rng.uniform(size=n) > 0.1
    return v, f, (sp, valid, None, o, d, None)


@pytest.mark.parametrize("huber", [0.0, 0.1])
@pytest.mark.parametrize("compat", [False, True])
def test_ray_loss_matches_jax_end_to_end(huber, compat):
    """The port's `ray_loss` (trace, kernels' plain versions, tail) against
    drt_tpu's, float64, brute oracles in both: the loss and its vertex
    gradient, at rtol 1e-10 (the scatters and the sums round in other
    orders)."""
    v, f, view = _loss_setup()
    with jax.enable_x64(True):
        jms = JMESH.build_mesh_state(v, f, dtype=jnp.float64)
        jview = tuple(None if a is None else jnp.asarray(a) for a in view)

        def jl(vv):
            loss, stats = j_ray_loss(jms.with_vertices(vv), jview,
                                     j_get_fn("brute"), IOR, EXT,
                                     huber=huber, compat=compat)
            return loss, stats["valid_rays"]
        (jloss, jvalid), jgrad = jax.value_and_grad(jl, has_aux=True)(
            jms.vertices)
        jloss, jgrad, jvalid = (np.asarray(jloss), np.asarray(jgrad),
                                int(jvalid))
    tms = build_mesh_state(v, f, dtype=torch.float64, device="cpu")
    tview = tuple(None if a is None else torch.from_numpy(np.asarray(a))
                  for a in view)
    vv = tms.vertices.clone().requires_grad_(True)
    loss, stats = t_ray_loss(tms.with_vertices(vv), tview, t_get_fn("brute"),
                             IOR, EXT, huber=huber, compat=compat)
    (grad,) = torch.autograd.grad(loss, vv)
    assert int(stats["valid_rays"]) == jvalid > 50
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-10)
    scale = np.abs(jgrad).max()
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-10,
                               atol=1e-10 * scale)


# -- the wrappers, as far as the CPU reaches them -----------------------------

def test_dispatch_by_device_and_refusals():
    """A device the kernels do not serve raises; each kernel's wrapper
    raises on CPU tensors, and on dtypes, shapes and layouts it does not
    take."""
    c = _torch(_case(np.float32))
    args = [c[k] for k in ("origin", "direction", "g9", "hit", "active",
                           "safe_id", "park")]
    with pytest.raises(ValueError, match="unsupported device"):
        TB.bounce_chain(*(a.to("meta") for a in args), IOR, EXT, EPS)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TB.bounce_cuda(*args, IOR, EXT, EPS)
    bad = list(args)
    bad[0] = args[0].half()
    with pytest.raises(ValueError, match="float32 or float64"):
        TB.bounce_cuda(*bad, IOR, EXT, EPS)
    for i, wrong, match in ((1, args[1].double(), "direction"),
                            (2, args[2][:, :6].contiguous(), "g9"),
                            (3, args[3].int(), "hit"),
                            (5, args[5].int(), "safe_id"),
                            (6, args[6][:2], "park"),
                            (1, args[1].t().contiguous().t(), "contiguous")):
        bad = list(args)
        bad[i] = wrong
        with pytest.raises(ValueError, match=match):
            TB.bounce_cuda(*bad, IOR, EXT, EPS)
    alive = TB.bounce_plain(*args, IOR, EXT, EPS)[2]
    with pytest.raises(ValueError, match="no cotangent"):
        TB.bounce_cuda_backward(*args[:3], alive, None, None, IOR, EXT, EPS)
    with pytest.raises(ValueError, match="no cotangent"):
        TB.bounce_plain_backward(*args[:3], alive, None, None, IOR, EXT, EPS)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TB.bounce_cuda_backward(*args[:3], alive, None, args[1], IOR, EXT,
                                EPS)
    t = _torch(_tail_case(np.float32))
    targs = [t[k] for k in ("origin", "direction", "screen_pixel",
                            "lane_valid", "active", "exit_hit")]
    with pytest.raises(ValueError, match="unsupported device"):
        TB.ray_tail(*(a.to("meta") for a in targs))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TB.ray_tail_cuda(*targs)
    with pytest.raises(ValueError, match="exit_hit"):
        TB.ray_tail_cuda(*targs[:5], targs[5].float())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TB.ray_tail_cuda_backward(*targs, 0.0, torch.ones(()))
    with pytest.raises(ValueError, match="g"):
        TB.ray_tail_cuda_backward(*targs, 0.0, torch.ones(1))


# A launch of each module that registers a library check (kernels.checks),
# and a library the check refuses: (attribute, value).
_CHECKED = {
    "bounce": ("ray_tail_blocks", TB.RAY_TAIL_BLOCKS * 2, "tail blocks"),
    "silhouette_pre": ("silhouette_sum_blocks", 8, "sum blocks"),
    "cg": ("cg_shared_budget", 1024, "shared memory"),
    "pack": ("pack_n_coef", 20, "pack_n_coef"),
    "scatter": ("scatter_cluster_size", 0, "no cluster"),
}


@pytest.mark.parametrize("launch", sorted(_CHECKED))
def test_without_nvcc_the_kernels_raise(monkeypatch, tmp_path, launch):
    """On a CUDA tensor the wrapper builds the kernels; where nvcc is
    missing that raises, before any module's check, and nothing runs the
    plain version instead."""
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    exists = kernels.os.path.exists
    monkeypatch.setattr(kernels.os.path, "exists",
                        lambda p: not p.endswith("nvcc") and exists(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.library(launch)


def _sources():
    """{signature function: the text of the csrc/*.cu that defines it}."""
    out = {}
    for path in glob.glob(os.path.join(os.path.dirname(kernels.__file__),
                                       "csrc", "*.cu")):
        src = open(path).read()
        for name in re.findall(r"const char\* (\w+_signature)\(\)", src):
            out[name] = src
    return out


def _source_names(src, sig):
    m = re.search(rf'const char\* {sig}\(\) \{{\s*return '
                  r'((?:"[^"]*"\s*)+);', src)
    assert m, sig
    return "".join(re.findall(r'"([^"]*)"', m.group(1))).split()


@pytest.mark.parametrize("entry", sorted(kernels.LAUNCHES))
def test_signatures_follow_the_source(entry):
    """Each launch's row in kernels.LAUNCHES names the arguments of its
    source's `*_signature()` (read from the source), in order, with one
    type each; csrc/bounce.cu's launch shapes are the plain version's."""
    sig = kernels._SIGNATURE_OF.get(entry, f"{entry}_signature")
    src = _sources()[sig]
    names, types = kernels.ROWS[entry]
    assert list(names) == _source_names(src, sig)
    assert len(types) == len(names)
    assert re.search(rf"\b{entry}_launch\(", src)
    if entry in ("bounce", "bounce_backward", "ray_tail",
                 "ray_tail_backward"):
        for name, value in (("BOUNCE_BLOCK", TB.BOUNCE_BLOCK),
                            ("RAY_TAIL_BLOCK", TB.RAY_TAIL_BLOCK),
                            ("RAY_TAIL_BLOCKS", TB.RAY_TAIL_BLOCKS)):
            assert re.search(rf"#define {name} {value}\b", src)


def test_every_signature_is_checked():
    """Every `*_signature()` of the sources is one `bind` checks."""
    assert set(_sources()) == set(kernels.signatures())


class _StubLib:
    """What ctypes.CDLL gives for the kernels' library: every entry point,
    each *_signature() answering `sigs`."""

    def __init__(self, sigs):
        for name in list(kernels._ENTRIES) + [f"{n}_launch"
                                              for n in kernels.LAUNCHES]:
            setattr(self, name, lambda *a: 0)
        for name, text in sigs.items():
            setattr(self, name, lambda text=text: text.encode())


@pytest.mark.parametrize("entry", sorted(kernels.signatures()))
def test_bind_checks_the_bounce_signatures(monkeypatch, entry):
    """`bind` takes a library whose signatures are the rows', and refuses
    one where a row's first two names (or kinds) are swapped."""
    sigs = kernels.signatures()
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: _StubLib(sigs))
    lib = kernels.bind("libdrt_kernels.so")
    for name, (_, types) in kernels.ROWS.items():
        assert getattr(lib, f"{name}_launch").argtypes == list(types)
    words = sigs[entry].split()
    words[0], words[1] = words[1], words[0]
    sigs[entry] = " ".join(words)
    with pytest.raises(RuntimeError, match=entry):
        kernels.bind("libdrt_kernels.so")


@pytest.mark.parametrize("launch", sorted(_CHECKED))
def test_lib_checks_the_launch_shapes(monkeypatch, launch):
    """Each module's registered check refuses a library whose launch
    shapes, constants or cluster are not the module's (the bounce tail's
    blocks, the silhouette sum's blocks, the CG shared route's budget, the
    oracle's coefficients a triangle, the scatter's cluster), before the
    module's first launch,
    and passes the library once they are, once per bound library."""
    sigs = kernels.signatures()
    stub = _StubLib(sigs)
    good = {"bounce_block": TB.BOUNCE_BLOCK,
            "ray_tail_block": TB.RAY_TAIL_BLOCK,
            "ray_tail_blocks": TB.RAY_TAIL_BLOCKS,
            "silhouette_block": SK.BLOCK,
            "silhouette_sum_blocks": SK.SUM_BLOCKS,
            "silhouette_bwd_block": SK.BWD_BLOCK,
            "silhouette_cluster_size": 16, "cg_ctas": TP.CG_CTAS,
            "cg_block": TP.CG_BLOCK, "cg_cluster_ready": 1,
            "cg_shared_budget": TP.CG_SHARED_BUDGET,
            "closest_hit_tri_chunk": CK.TRI_CHUNK,
            "closest_hit_max_ray_tile": CK.MAX_RAY_TILE,
            "candidates_max_ray_tile": CK.MAX_RAY_TILE,
            "candidates_max_chunks": CK.MAX_CHUNKS,
            "pack_tri_chunk": CK.TRI_CHUNK, "pack_n_coef": CK.N_COEF,
            "ray_order_axis_bits": CK.ORDER_AXIS_BITS,
            "scatter_cluster_size": 16}
    for name, value in good.items():
        setattr(stub, name, lambda value=value: value)

    def shared_bytes(vp, c, d, f64):
        got = TP.cg_shared_bytes(vp, c, d, torch.float64 if f64
                                 else torch.float32)
        return -1 if got is None else got
    stub.cg_shared_bytes = shared_bytes
    attr, bad, match = _CHECKED[launch]
    setattr(stub, attr, lambda: bad)
    monkeypatch.setattr(kernels, "load", lambda: stub)
    monkeypatch.setattr(kernels, "_checked", {})
    with pytest.raises(RuntimeError, match=match):
        kernels.library(launch)
    setattr(stub, attr, lambda: good[attr])
    assert kernels.library(launch) is stub
    setattr(stub, attr, lambda: bad)          # checked once for this library
    assert kernels.library(launch) is stub


def test_counters_count_the_new_kernels():
    c = kernels.LaunchCounter()
    for name in ("bounce_launches", "bounce_backward_launches",
                 "ray_tail_launches", "ray_tail_backward_launches"):
        assert c.snapshot()[name] == 0
        c.add({name: 2}, times=3)
        assert getattr(c, name) == 6
    c.reset()
    assert c.bounce_launches == c.ray_tail_launches == 0


def test_bounce_debug_checks_still_report(monkeypatch, capfd):
    """DRT_TPU_DEBUG beside the kernel: a side recomputation's TIR
    cross-check reports a mismatch, and the finite-ray check reports a
    non-finite ray the chain returned."""
    monkeypatch.setenv("DRT_TPU_DEBUG", "1")
    c = _torch(_case(np.float64, seed=7))
    real = TT.fresnel_dielectric

    def flipped(cos_i, eta_i, eta_t):
        tir, r = real(cos_i, eta_i, eta_t)
        return torch.logical_not(tir), r
    monkeypatch.setattr(TT, "fresnel_dielectric", flipped)
    o_out, d_out, alive, _ = TB.bounce_plain(
        c["origin"], c["direction"], c["g9"], c["hit"], c["active"],
        c["safe_id"], c["park"], IOR, EXT, EPS)
    o_bad = o_out.clone()
    o_bad[torch.nonzero(alive)[0, 0]] = float("nan")
    TT._debug_bounce(c["origin"], c["direction"], c["g9"], c["hit"], IOR,
                     EXT, EPS, False, o_bad, d_out, alive)
    out = capfd.readouterr().out
    assert "VIOLATION [TIR FrDielectric/Refract mismatch]" in out
    assert "VIOLATION [non-finite ray after bounce]: 1 lanes" in out
