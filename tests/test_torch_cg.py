"""The Sobolev preconditioner's CG solve of drt_tpu_torch (its plain version
`cg_plain`, `cg` on `ordered_matvec`, which csrc/cg.cu must equal bit for
bit on the card) against drt_tpu on the CPU, and the kernel's wrapper as
far as it can be checked without a card.

Tolerances: float64 solves and gradients at rtol 1e-9 of the largest entry
(as tests/test_torch_precondition.py); float32 at 1e-5 of the largest
entry, because the port sums every dot product in the kernel's fixed tree
where XLA sums in its own order, and 64 trips carry those roundings
(measured: 2.7e-7 on the cube, 9e-8 on the icosphere). The matvec in table
order against `sobolev_matvec` at rtol 1e-12 (float64)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.mesh as JMESH
from drt_tpu.optimize import precondition as JP
from drt_tpu_torch import kernels
from drt_tpu_torch.mesh import build_mesh_state
from drt_tpu_torch.optimize import precondition as TP
from tests.meshes import make_cube, make_icosphere

torch.set_num_threads(min(2, torch.get_num_threads()))

MESHES = {"icosphere": lambda: make_icosphere(subdivisions=2, radius=10.0),
          "cube": lambda: make_cube(size=4.0)}
TOL = {np.float64: 1e-9, np.float32: 1e-5}


def _both(name, dtype):
    v, f = MESHES[name]()
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    with jax.enable_x64(dtype == np.float64):
        jms = JMESH.build_mesh_state(v, f, dtype=jdt)
    tms = build_mesh_state(v, f, dtype=tdt, device="cpu")
    return jms, tms


def _close(t, j, rtol):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=rtol,
                               atol=rtol * np.abs(j).max())


def _jax_solve(jms, u, w, lam, maxiter, tol, x0, dtype):
    with jax.enable_x64(dtype == np.float64):
        x0j = None if x0 is None else jnp.asarray(x0)

        def jf(u_):
            v = JP.sobolev_solve(u_, jms.neighbors, jms.neighbor_valid, lam,
                                 maxiter=maxiter, tol=tol, x0=x0j)
            return jnp.sum(v * jnp.asarray(w)), v
        (_, jv), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(u))
        return np.asarray(jv), np.asarray(jg)


@pytest.mark.parametrize("x0", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("maxiter,tol", [(5, 1e-10), (64, 1e-6)])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_plain_solve_value_and_gradient_match_jax(mesh, maxiter, tol, dtype,
                                                  x0):
    """`sobolev_solve` on CPU tensors (the plain version) against JAX's in
    value and input gradient, from zeros and from a given x0."""
    jms, tms = _both(mesh, dtype)
    rng = np.random.default_rng(3)
    shape = tuple(tms.vertices.shape)
    u = rng.normal(size=shape).astype(dtype)
    w = rng.normal(size=shape).astype(dtype)
    x0v = (0.1 * rng.normal(size=shape)).astype(dtype) if x0 else None
    jv, jg = _jax_solve(jms, u, w, 29.0, maxiter, tol, x0v, dtype)
    tu = torch.tensor(u, requires_grad=True)
    tv = TP.sobolev_solve(tu, tms.neighbors, tms.neighbor_valid, 29.0,
                          maxiter=maxiter, tol=tol,
                          x0=None if x0v is None else torch.tensor(x0v))
    (tg,) = torch.autograd.grad((tv * torch.tensor(w)).sum(), tu)
    assert tv.dtype == tu.dtype
    _close(tv, jv, TOL[dtype])
    _close(tg, jg, TOL[dtype])


def _jax_trips(jms, u, lam, tol, limit):
    """The trips JAX's cg takes: the least maxiter from which its result
    no longer changes (float64 on the CPU runs the same operations)."""
    with jax.enable_x64(True):
        def solve(k):
            return np.asarray(JP.sobolev_solve(
                jnp.asarray(u), jms.neighbors, jms.neighbor_valid, lam,
                maxiter=k, tol=tol))
        final = solve(limit)
        k = limit
        while k > 0 and np.array_equal(solve(k - 1), final):
            k -= 1
        return k


@pytest.mark.parametrize("tol", [1e-3, 1e-6])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_trip_count_equals_jax_when_tol_is_reached(mesh, tol):
    jms, tms = _both(mesh, np.float64)
    u = np.random.default_rng(4).normal(size=tuple(tms.vertices.shape))
    _, trips = TP.cg_plain(torch.tensor(u), tms.neighbors,
                           tms.neighbor_valid, 29.0, tol=tol, maxiter=200)
    trips = int(trips)
    assert 0 < trips < 200
    assert _jax_trips(jms, u, 29.0, tol, trips + 2) == trips


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ordered_matvec_matches_sobolev_matvec_and_jax(mesh):
    jms, tms = _both(mesh, np.float64)
    x = np.random.default_rng(5).normal(size=tuple(tms.vertices.shape))
    with jax.enable_x64(True):
        ja = JP.sobolev_matvec(jnp.asarray(x), jms.neighbors,
                               jms.neighbor_valid, 19.0)
    tx = torch.tensor(x)
    got = TP.ordered_matvec(tms.neighbors, tms.neighbor_valid, 19.0,
                            torch.float64)(tx)
    _close(got, ja, 1e-12)
    _close(got, TP.sobolev_matvec(tx, tms.neighbors, tms.neighbor_valid,
                                  19.0).numpy(), 1e-12)


def test_plain_solve_takes_negative_entries_as_jax_does():
    """Valid entries given from the end (n - Vp) on even rows: the plain
    version, which csrc/cg.cu follows, takes them as n, as JAX's indexing
    does, and so solves the system of the table as given (float64)."""
    jms, tms = _both("icosphere", np.float64)
    nbr = tms.neighbors.clone()
    even = (torch.arange(nbr.shape[0])[:, None] % 2 == 0) & tms.neighbor_valid
    nbr[even] -= nbr.shape[0]
    assert (nbr < 0).any()
    u = np.random.default_rng(6).normal(size=tuple(tms.vertices.shape))
    got, trips = TP.cg_plain(torch.tensor(u), nbr, tms.neighbor_valid, 29.0,
                             tol=1e-6, maxiter=64)
    same, same_trips = TP.cg_plain(torch.tensor(u), tms.neighbors,
                                   tms.neighbor_valid, 29.0, tol=1e-6,
                                   maxiter=64)
    assert torch.equal(got, same) and int(trips) == int(same_trips)
    with jax.enable_x64(True):
        jv = JP.sobolev_solve(jnp.asarray(u), jnp.asarray(nbr.numpy()),
                              jms.neighbor_valid, 29.0, maxiter=64, tol=1e-6)
    _close(got, jv, TOL[np.float64])


def _tree_numpy(u, v, dtype):
    """The dot product in csrc/cg.cu's order, written out in numpy: element
    e to thread e % threads, each thread's products summed from +0 in
    ascending e, then halving trees over lanes, warps and CTAs."""
    threads = TP.CG_CTAS * TP.CG_BLOCK
    prod = (u.astype(dtype) * v.astype(dtype)).reshape(-1)
    part = np.zeros(threads, dtype)
    for e, x in enumerate(prod):
        part[e % threads] = dtype(part[e % threads] + x)
    levels = part.reshape(TP.CG_CTAS, TP.CG_BLOCK // 32, 32)
    for axis in (2, 1, 0):
        while levels.shape[axis] > 1:
            h = levels.shape[axis] // 2
            levels = (np.take(levels, range(h), axis)
                      + np.take(levels, range(h, 2 * h), axis))
    return dtype(levels.reshape(()))


@pytest.mark.parametrize("n", [1, 97, 16384, 16385, 98304, 100003])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ordered_dot_is_the_kernel_order_and_near_torch_dot(n, dtype):
    rng = np.random.default_rng(n)
    u, v = rng.normal(size=n).astype(dtype), rng.normal(size=n).astype(dtype)
    got = TP.ordered_dot(torch.tensor(u), torch.tensor(v))
    assert got.shape == ()
    want = _tree_numpy(u, v, dtype)
    assert got.numpy().tobytes() == np.asarray(want, dtype).tobytes()
    ref = torch.dot(torch.tensor(u), torch.tensor(v))
    eps = np.finfo(dtype).eps
    assert abs(float(got) - float(ref)) <= 2 * n * eps * float(
        np.abs(u.astype(np.float64) * v).sum())


def test_ordered_dot_sums_from_positive_zero():
    """-0 products give +0, as the kernel's sums from +0 do."""
    neg = torch.tensor([-0.0, 0.0, -0.0])
    got = TP.ordered_dot(neg, torch.ones(3))
    assert got.item() == 0.0 and not torch.signbit(got)


def test_sobolev_solve_on_cpu_takes_the_plain_version(monkeypatch):
    """CPU tensors: the plain version's bits and no kernel launch; the
    kernel's wrapper is never reached."""
    _, tms = _both("icosphere", np.float32)
    u = torch.tensor(np.random.default_rng(6).normal(
        size=tuple(tms.vertices.shape)), dtype=torch.float32)

    def no_kernel(*a, **k):
        raise AssertionError("cg_cuda called on CPU tensors")
    monkeypatch.setattr(TP, "cg_cuda", no_kernel)
    before = kernels.counters.cg_launches
    got = TP.sobolev_solve(u, tms.neighbors, tms.neighbor_valid, 29.0,
                           maxiter=12)
    want, _ = TP.cg_plain(u, tms.neighbors, tms.neighbor_valid, 29.0,
                          tol=1e-6, maxiter=12)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert kernels.counters.cg_launches == before


def test_cg_cuda_refuses_what_the_kernel_does_not_take():
    _, tms = _both("cube", np.float32)
    b = torch.zeros(tuple(tms.vertices.shape))
    nbr, valid = tms.neighbors, tms.neighbor_valid
    with pytest.raises(ValueError, match="CUDA"):
        TP.cg_cuda(b, nbr, valid, 1.0)
    with pytest.raises(ValueError, match="float32 or float64"):
        TP.cg_cuda(b.half(), nbr, valid, 1.0)
    with pytest.raises(ValueError, match="int64"):
        TP.cg_cuda(b, nbr.int(), valid, 1.0)
    with pytest.raises(ValueError, match="bool"):
        TP.cg_cuda(b, nbr, valid.int(), 1.0)
    with pytest.raises(ValueError, match="x0"):
        TP.cg_cuda(b, nbr, valid, 1.0, x0=b.double())
    with pytest.raises(ValueError, match="contiguous"):
        TP.cg_cuda(b.t().contiguous().t(), nbr, valid, 1.0)


def _source():
    return open(os.path.join(os.path.dirname(kernels.__file__), "csrc",
                             "cg.cu")).read()


def test_launch_args_follow_the_kernel_signature(monkeypatch):
    """cg_cuda passes its arguments by the names of csrc/cg.cu's
    cg_signature() (read from the source), which kernels.LAUNCHES types
    and the binding checks: with the library a recorder and the card's
    stream a stub, each launch's arguments are the wrapper's tensors and
    numbers under their names, on either route; the summation order's
    constants are the source's."""
    import contextlib
    import types
    src = _source()
    sig = re.search(r'cg_signature\(\) \{\s*return "([^"]*)"\s*"([^"]*)";',
                    src)
    assert sig
    names = (sig.group(1) + sig.group(2)).split()
    assert list(kernels.ROWS["cg"][0]) == names
    argtypes = kernels.ROWS["cg"][1]
    assert len(argtypes) == len(names)
    assert re.search(rf"#define CG_CTAS {TP.CG_CTAS}\b", src)
    assert re.search(rf"#define CG_BLOCK {TP.CG_BLOCK}\b", src)
    calls = []
    lib = types.SimpleNamespace(
        cg_scratch_bytes=lambda vp, c, d, f64: 64,
        cg_shared_scratch_bytes=lambda vp, f64: 32,
        cg_launch=lambda *a: calls.append(("cg", a)) or 0,
        cg_shared_launch=lambda *a: calls.append(("cg_shared", a)) or 0)
    monkeypatch.setattr(kernels, "library", lambda name: lib)
    monkeypatch.setattr(kernels, "need_cuda", lambda what, t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=1234))
    vp, c, d = 5, 3, 4
    b = torch.zeros((vp, c), dtype=torch.float64)
    x0 = torch.ones((vp, c), dtype=torch.float64)
    nbr = torch.zeros((vp, d), dtype=torch.int64)
    valid = torch.ones((vp, d), dtype=torch.bool)
    before = kernels.counters.snapshot()
    for route in ("global", "shared"):
        for given in (None, x0):
            x, trips = TP.cg_cuda(b, nbr, valid, 29.0, tol=1e-3, maxiter=17,
                                  x0=given, route=route)
            name, got = calls.pop()
            assert name == ("cg_shared" if route == "shared" else "cg")
            args = dict(zip(names, got))
            assert list(args) == names
            assert args["x0"] == (None if given is None else x0.data_ptr())
            assert (args["b"], args["nbr"], args["valid"], args["x"],
                    args["trips"]) == (
                b.data_ptr(), nbr.data_ptr(), valid.data_ptr(),
                x.data_ptr(), trips.data_ptr())
            assert (args["f64"], args["vp"], args["c"], args["d"],
                    args["maxiter"], args["stream"]) == (1, vp, c, d, 17,
                                                         1234)
            assert args["lam"] == 29.0 and args["tol2"] == 1e-3 * 1e-3
            # ctypes takes each value as its declared type
            for value, kind in zip(got, argtypes):
                if value is not None:
                    kind(value)
    after = kernels.counters.snapshot()
    for name, n in (("cg_launches", 4), ("cg_shared_launches", 2),
                    ("cg_global_launches", 2)):
        assert after[name] == before[name] + n
    TP.cg_cuda(b.float(), nbr, valid, 1.0, tol=0.5, maxiter=1)
    assert dict(zip(names, calls.pop()[1]))["f64"] == 0


class _StubLib:
    """What ctypes.CDLL gives for the kernels' library: every entry point,
    each *_signature() answering `sigs`."""

    def __init__(self, sigs):
        for name in list(kernels._ENTRIES) + [f"{n}_launch"
                                              for n in kernels.LAUNCHES]:
            setattr(self, name, lambda *a: 0)
        for name, text in sigs.items():
            setattr(self, name, lambda text=text: text.encode())


def test_bind_checks_the_cg_signature(monkeypatch):
    sigs = kernels.signatures()
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: _StubLib(sigs))
    lib = kernels.bind("libdrt_kernels.so")
    assert lib.cg_signature() == " ".join(kernels.ROWS["cg"][0]).encode()
    assert lib.cg_launch.argtypes == list(kernels.ROWS["cg"][1])
    sigs["cg_signature"] = sigs["cg_signature"].replace("lam tol2",
                                                        "tol2 lam")
    with pytest.raises(RuntimeError, match="cg_signature"):
        kernels.bind("libdrt_kernels.so")


def test_counters_count_cg_launches():
    c = kernels.LaunchCounter()
    assert c.snapshot()["cg_launches"] == 0
    c.add({"cg_launches": 2}, times=3)
    assert c.cg_launches == 6
    c.reset()
    assert c.cg_launches == 0


# -- csrc/cg.cu's two routes, as far as the CPU reaches them ------------------

def _shared_bytes_by_hand(vp, c, d, dtype):
    """The shared route's bytes, counted from the ownership map itself: a
    row for every (CTA, vertex) with an element owned there, p's vertex
    slots, Ap and the own-element index for each chunk a thread owns."""
    size = 8 if dtype == torch.float64 else 4
    n = vp * c
    chunks = -(-n // TP.CG_THREADS)
    e = np.arange(n)
    cta = (e // TP.CG_BLOCK) % TP.CG_CTAS
    pairs = np.unique(cta * vp + e // c) if n else np.zeros(0, np.int64)
    rows = np.bincount(pairs // vp, minlength=TP.CG_CTAS).max() if n else 0
    spc = (TP.CG_BLOCK - 1) // c + 1
    return (TP.CG_SHARED_HEAD + (chunks * (spc + 1) + 1) * 4 * size
            + chunks * TP.CG_BLOCK * (size + 2) + rows * TP.CG_SHARED_ROW)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("vp", [0, 1, 5, 1024, 5461, 16384, 21845, 21846,
                                32768, 65536])
def test_cg_shared_bytes_count_the_rows_and_vectors(vp, c, dtype):
    """`cg_shared_bytes` (csrc/cg.cu's formula, held to the library's on
    the card) against a count from the ownership map, where the route takes
    the solve; None where a thread would own more chunks than it holds."""
    got = TP.cg_shared_bytes(vp, c, 8, dtype)
    chunks = -(-vp * c // TP.CG_THREADS)
    if chunks > TP.CG_SHARED_CHUNKS[dtype]:
        assert got is None
    else:
        assert got == _shared_bytes_by_hand(vp, c, 8, dtype)
        assert TP.cg_shared_rows(vp, c) * TP.CG_SHARED_ROW <= got


@pytest.mark.parametrize("vp,c,d,dtype,route", [
    (16384, 3, 8, torch.float32, "shared"),      # dog_mid20k
    (32768, 3, 8, torch.float32, "shared"),      # dog_mid45k
    (65536, 3, 8, torch.float32, "shared"),      # dog_mid90k
    (65536, 3, 1, torch.float32, "shared"),
    (65536, 3, 9, torch.float32, "global"),      # d above the cap
    (65537, 3, 8, torch.float32, "global"),
    (131072, 3, 8, torch.float32, "global"),
    (65536, 3, 8, torch.float64, "global"),
    (21845, 3, 8, torch.float64, "shared"),
    (21846, 3, 8, torch.float64, "global"),
    (49152, 4, 8, torch.float32, "shared"),
    (1024, 5, 8, torch.float32, "global"),       # C above the cap
    (1024, 3, 8, torch.float16, "global"),
])
def test_cg_route_by_size(vp, c, d, dtype, route):
    assert TP.cg_route(vp, c, d, dtype) == route
    need = TP.cg_shared_bytes(vp, c, d, dtype)
    assert (need is not None and need <= TP.CG_SHARED_BUDGET) == (
        route == "shared")


def test_cg_route_follows_the_byte_budget(monkeypatch):
    """The route is "shared" exactly where `cg_shared_bytes` fits the
    budget: at a budget one byte short of a solve's bytes it is "global"."""
    need = TP.cg_shared_bytes(32768, 3, 8, torch.float32)
    assert TP.cg_route(32768, 3, 8, torch.float32) == "shared"
    monkeypatch.setattr(TP, "CG_SHARED_BUDGET", need)
    assert TP.cg_route(32768, 3, 8, torch.float32) == "shared"
    monkeypatch.setattr(TP, "CG_SHARED_BUDGET", need - 1)
    assert TP.cg_route(32768, 3, 8, torch.float32) == "global"
    assert TP.cg_route(16384, 3, 8, torch.float32) == "shared"


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("vp", [1024, 16384, 65536])
def test_cg_owner_covers_every_element_once(vp, c):
    """`cg_owner` places each element of [Vp*C] at one (CTA, slot), the CTA
    (e % 16384) // 1024, the slot's thread e % 16384, in the chunk e //
    16384: the fixed summation order's thread, as csrc/cg.cu lays out r
    and Ap."""
    n = vp * c
    cta, slot = zip(*(TP.cg_owner(e) for e in range(n)))
    cta, slot, e = np.array(cta), np.array(slot), np.arange(n)
    assert len(set(zip(cta.tolist(), slot.tolist()))) == n
    assert np.array_equal(cta, (e % TP.CG_THREADS) // TP.CG_BLOCK)
    assert np.array_equal(cta * TP.CG_BLOCK + slot % TP.CG_BLOCK,
                          e % TP.CG_THREADS)
    assert np.array_equal(slot // TP.CG_BLOCK, e // TP.CG_THREADS)
    assert slot.max() < -(-n // TP.CG_THREADS) * TP.CG_BLOCK


def test_cg_cuda_refuses_a_route_it_cannot_take():
    """A route that is not one, and the shared route where `cg_route` does
    not give it, are refused before any launch (on any device)."""
    _, tms = _both("cube", np.float32)
    b = torch.zeros(tuple(tms.vertices.shape))
    nbr, valid = tms.neighbors, tms.neighbor_valid
    with pytest.raises(ValueError, match="route"):
        TP.cg_cuda(b, nbr, valid, 1.0, route="cluster")
    extra = TP.CG_SHARED_MAX_D + 1 - nbr.shape[1]
    wide = torch.cat([nbr, nbr[:, :1].repeat(1, extra)], dim=1)
    wide_valid = torch.cat([valid, valid[:, :1].repeat(1, extra)], dim=1)
    with pytest.raises(ValueError, match="shared route"):
        TP.cg_cuda(b, wide, wide_valid, 1.0, route="shared")
    with pytest.raises(ValueError, match="shared route"):
        TP.cg_cuda(b[:, :1].repeat(1, 5), nbr, valid, 1.0, route="shared")
    for route in (None, "global", "shared"):
        with pytest.raises(ValueError, match="CUDA"):
            TP.cg_cuda(b, nbr, valid, 1.0, route=route)


def test_shared_launch_follows_the_kernel_signature():
    """csrc/cg.cu's cg_shared_launch takes cg_launch's arguments (read from
    the source), one row each in kernels.LAUNCHES; the binding types and
    checks them; the source's shared-route constants are the wrapper's."""
    src = _source()
    sig = re.search(r'cg_shared_signature\(\) \{\s*return "([^"]*)"\s*'
                    r'"([^"]*)";', src)
    assert sig
    names = (sig.group(1) + sig.group(2)).split()
    assert list(kernels.ROWS["cg_shared"][0]) == names
    assert kernels.ROWS["cg_shared"] == kernels.ROWS["cg"]
    for name, value in (("CG_SHARED_MAX_D", TP.CG_SHARED_MAX_D),
                        ("CG_SHARED_MAX_VP", TP.CG_SHARED_MAX_VP),
                        ("CG_SHARED_MAX_C", TP.CG_SHARED_MAX_C),
                        ("CG_SHARED_HEAD", TP.CG_SHARED_HEAD),
                        ("CG_SHARED_ROW", TP.CG_SHARED_ROW)):
        assert re.search(rf"#define {name} {value}\b", src), name
    for dtype, ctype in ((torch.float32, "float"), (torch.float64, "double")):
        assert re.search(rf"struct SharedTune<{ctype}> \{{\s*static constexpr"
                         rf" int chunks = {TP.CG_SHARED_CHUNKS[dtype]},", src)


def test_bind_checks_the_shared_signature(monkeypatch):
    sigs = kernels.signatures()
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: _StubLib(sigs))
    lib = kernels.bind("libdrt_kernels.so")
    assert (lib.cg_shared_launch.argtypes
            == list(kernels.ROWS["cg_shared"][1]))
    sigs["cg_shared_signature"] = sigs["cg_shared_signature"].replace(
        "x trips", "trips x")
    with pytest.raises(RuntimeError, match="cg_shared_signature"):
        kernels.bind("libdrt_kernels.so")


def test_counters_count_cg_launches_by_route():
    c = kernels.LaunchCounter()
    snap = c.snapshot()
    assert snap["cg_shared_launches"] == snap["cg_global_launches"] == 0
    c.add({"cg_launches": 3, "cg_shared_launches": 2,
           "cg_global_launches": 1}, times=2)
    assert (c.cg_launches, c.cg_shared_launches,
            c.cg_global_launches) == (6, 4, 2)
    c.reset()
    assert c.cg_shared_launches == c.cg_global_launches == 0
