"""The oracle's packing stages in the port (`pack_plain`, what the "cuda"
backend runs on CPU tensors and the plain version of csrc/pack.cu) against
the JAX package and against the torch stages it is made of, on numpy inputs
from a seed.

Against JAX (`intersect_pallas`'s stages): the coefficients against
`pallas_kernel._coef_packed` through the row map at rtol 1e-6 / atol 1e-6
(tests/test_torch_intersect.py's tolerance: JAX's cross product may round
its two products otherwise); the chunk boxes and their validity against
`culled._chunk_aabbs` and the group boxes against pallas_kernel.py:449-471
written out in jnp, exactly; the ray features against :473-487, exactly but
for o x d (the same tolerance).

Against the stages as `prepare_inputs` composed them before the packing
kernel: every output bit for bit (int32 views), but for the sign of a zero
in the boxes, which `pack_plain` makes +0 as the kernel does.

Cases: the icosphere and the cube (padded to whole power-of-two face
arrays, the padding invalid), dog_mid20k (17,426 faces: the last chunk
holds faces beyond F) and dog_pillow_corrupt.ply with 1 face in 64 made
degenerate and 1 in 10 invalid; groups 1, 4 and 16 (padding chunks on
the cube and dog_mid20k, whose 2 and 137 chunks neither group divides);
float32 and float64 vertices; 1,000 rays
(not a multiple of either ray tile) with exact zeros of both signs in the
directions; and the icosphere with -0 coordinates under a zero shift."""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drt_tpu.mesh as JMESH
import drt_tpu_torch.intersect.cuda_kernel as CK
from drt_tpu.intersect.culled import _chunk_aabbs as j_chunk_aabbs
from drt_tpu.intersect.pallas_kernel import _coef_packed as j_coef_packed
from drt_tpu_torch.mesh import load_ply
from tests.meshes import make_cube, make_icosphere

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("icosphere", "cube", "dog20k", "pillow", "zeros")
GROUPS = (1, 4, 16)
N_RAYS = 1000


@functools.lru_cache(maxsize=None)
def _mesh(name):
    """(vertices [V,3] f64, faces [F,3] i64, face_valid [F] bool, shift [3]
    f32 or None: the mean ray origin)."""
    rng = np.random.default_rng(5)
    if name in ("icosphere", "cube", "zeros"):
        v, f = (make_cube(size=80.0) if name == "cube"
                else make_icosphere(subdivisions=3, radius=50.0))
        jms = JMESH.build_mesh_state(v, f)
        v = np.asarray(jms.vertices, np.float64)
        f = np.asarray(jms.faces, np.int64)
        fv = np.array(jms.face_valid)
        if name == "zeros":
            v = np.where(v == 0, -0.0, v)       # -0 coordinates, shift 0
            v[::5, 0] = 0.0
            return v, f, fv, np.zeros(3, np.float32)
        return v, f, fv, None
    path = (os.path.join(ROOT, "reports", "tuning_meshes", "dog_mid20k.ply")
            if name == "dog20k"
            else os.path.join(ROOT, "tests", "fixtures",
                              "dog_pillow_corrupt.ply"))
    v, f = load_ply(path)
    v, f = np.asarray(v, np.float64), np.asarray(f, np.int64).copy()
    fv = np.ones(len(f), bool)
    if name == "pillow":
        f[::64, 2] = f[::64, 1]                 # zero-area triangles
        fv = rng.uniform(size=len(f)) > 0.1
    return v, f, fv, None


@functools.lru_cache(maxsize=None)
def _rays(name):
    """[N,3] float32 origins around the mesh and directions, every 7th
    direction with an exact +0 and every 11th a -0 component."""
    v, _, _, _ = _mesh(name)
    rng = np.random.default_rng(9)
    c, ext = v.mean(0), np.ptp(v, axis=0).max()
    o = (c + rng.normal(size=(N_RAYS, 3)) * ext).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d[::7, 1] = 0.0
    d[::11, 2] = -0.0
    d[3, :] = 0.0
    return o, d


def _inputs(name, vdtype):
    """The torch inputs of pack_plain and the shift as numpy f32."""
    v, f, fv, shift = _mesh(name)
    o, d = _rays(name)
    if shift is None:
        shift = torch.from_numpy(o).mean(dim=0).numpy()
    return ((torch.tensor(v, dtype=vdtype), torch.from_numpy(f),
             torch.from_numpy(fv), torch.from_numpy(shift),
             torch.from_numpy(o), torch.from_numpy(d)), shift)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same_bits(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(_bits(a), _bits(b)))


def _jax_group_boxes(lo_c, hi_c, chunk_valid, group):
    """pallas_kernel.py:449-471: the prepass's boxes at `group`."""
    if group == 1:
        return lo_c, hi_c, chunk_valid
    NC = lo_c.shape[0]
    NCg = -(-NC // group) * group
    padc = NCg - NC
    if padc:
        lo_c = jnp.pad(lo_c, ((0, padc), (0, 0)), constant_values=jnp.inf)
        hi_c = jnp.pad(hi_c, ((0, padc), (0, 0)), constant_values=jnp.inf)
        chunk_valid = jnp.pad(chunk_valid, (0, padc))
    lo_m = jnp.where(chunk_valid[:, None], lo_c, jnp.inf)
    hi_m = jnp.where(chunk_valid[:, None], hi_c, -jnp.inf)
    return (lo_m.reshape(NCg // group, group, 3).min(axis=1),
            hi_m.reshape(NCg // group, group, 3).max(axis=1),
            chunk_valid.reshape(NCg // group, group).any(axis=1))


def _jax_ray_features(o, d, shift, ray_tile):
    """pallas_kernel.py:473-487: inv3 and the first 9 rows of phiT, as
    [3,Np] and [9,Np]."""
    o = jnp.asarray(o) - jnp.asarray(shift)
    d = jnp.asarray(d)
    pad = (-o.shape[0]) % ray_tile
    if pad:
        o = jnp.pad(o, ((0, pad), (0, 0)))
        d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    T = o.shape[0] // ray_tile
    ot = o.reshape(T, ray_tile, 3).transpose(0, 2, 1)
    dt = d.reshape(T, ray_tile, 3).transpose(0, 2, 1)
    dsafe = jnp.where(jnp.abs(dt) > 1e-20, dt,
                      jnp.where(dt >= 0, 1e-20, -1e-20))
    inv3 = 1.0 / dsafe
    w = jnp.cross(ot, dt, axis=1)
    phiT = jnp.concatenate([dt, w, ot], axis=1)              # [T,9,RT]

    def rows(x):
        return np.asarray(x).transpose(1, 0, 2).reshape(x.shape[1], -1)
    return rows(inv3), rows(phiT)


@functools.lru_cache(maxsize=None)
def _jax_stages(name):
    """JAX's coefficients, chunk boxes and ray features of a case (the
    vertices as .float() gives them, whatever their type)."""
    v, f, fv, _ = _mesh(name)
    (_, _, _, shift, o, d), shift = _inputs(name, torch.float32)
    jv = jnp.asarray(v.astype(np.float32))
    jc, nc = j_coef_packed(jv, jnp.asarray(f), jnp.asarray(fv),
                           jnp.asarray(shift), CK.TRI_CHUNK)
    boxes = j_chunk_aabbs(jv, jnp.asarray(f), jnp.asarray(fv),
                          jnp.asarray(shift), CK.TRI_CHUNK)
    rays = _jax_ray_features(o.numpy(), d.numpy(), shift,
                             CK.RAY_TILE_INCOHERENT)
    return (np.array(jc), nc, *(np.array(x) for x in boxes), *rays)


@pytest.mark.parametrize("vdtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("name", MESHES)
def test_pack_plain_matches_jax(name, group, vdtype):
    args, _ = _inputs(name, vdtype)
    pk = CK.pack_plain(*args, group=group, ray_tile=CK.RAY_TILE_INCOHERENT)
    jc, nc, jlo, jhi, jcv, inv, phi = _jax_stages(name)
    ncg = -(-nc // group) * group
    C = CK.TRI_CHUNK
    assert tuple(pk.coef.shape) == (ncg, CK.N_COEF, C)
    for k, (row, col) in enumerate(zip(CK.COEF_ROWS, CK.COEF_COLS)):
        np.testing.assert_allclose(pk.coef[:nc, k].numpy(),
                                   jc[:, row, col * C:(col + 1) * C],
                                   rtol=1e-6, atol=1e-6)
    assert not pk.coef[nc:].any()              # the padding chunks
    if group == 1:
        np.testing.assert_array_equal(pk.lo.numpy(), jlo)
        np.testing.assert_array_equal(pk.hi.numpy(), jhi)
    else:
        # a chunk without a valid face gets +inf (JAX keeps the mesh's own
        # inverted box there and pads with +inf)
        for mine, jax_box in ((pk.lo, jlo), (pk.hi, jhi)):
            mine = mine.numpy()
            np.testing.assert_array_equal(mine[:nc][jcv], jax_box[jcv])
            assert np.isposinf(mine[:nc][~jcv]).all()
            assert np.isposinf(mine[nc:]).all()
    glo, ghi, gcv = (np.asarray(x) for x in _jax_group_boxes(
        jnp.asarray(jlo), jnp.asarray(jhi), jnp.asarray(jcv), group))
    np.testing.assert_array_equal(pk.box_lo.numpy(), glo)
    np.testing.assert_array_equal(pk.box_hi.numpy(), ghi)
    np.testing.assert_array_equal(pk.box_valid.numpy(), gcv)
    assert 0 < int(pk.box_valid.sum()) <= pk.box_valid.numel()
    np.testing.assert_array_equal(pk.inv.numpy(), inv)
    np.testing.assert_array_equal(pk.phi[:3].numpy(), phi[:3])
    np.testing.assert_array_equal(pk.phi[6:].numpy(), phi[6:])
    np.testing.assert_allclose(pk.phi[3:6].numpy(), phi[3:6], rtol=1e-6,
                               atol=1e-6)


def _parent_stages(vertices, faces, face_valid, shift, origins, dirs, group,
                   ray_tile):
    """The torch stages as prepare_inputs composed them before csrc/pack.cu
    (shift given)."""
    o = origins.float() - shift
    d = dirs.float()
    coef, _ = CK._coef_packed(vertices, faces, face_valid, shift,
                              CK.TRI_CHUNK)
    lo, hi, chunk_valid = CK._chunk_aabbs(vertices, faces, face_valid, shift,
                                          CK.TRI_CHUNK)
    coef = CK._pad_axis0(coef, group)
    lo, hi, boxes = CK._grouped_boxes(lo, hi, chunk_valid, group)
    o = CK._pad_axis0(o, ray_tile)
    d = CK._pad_axis0(d, ray_tile, 1.0)
    inv = CK._safe_inv(d).t().contiguous()
    w = torch.linalg.cross(o, d, dim=-1)
    phi = torch.cat([d, w, o], dim=1).t().contiguous()
    return CK.Packed(coef, lo, hi, *boxes, phi, inv)


@pytest.mark.parametrize("coherent", [False, True])
@pytest.mark.parametrize("vdtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("name", MESHES)
def test_pack_plain_is_the_torch_stages(name, group, vdtype, coherent):
    """Bit for bit with the stages it replaced, every zero of the boxes
    made +0 in theirs (the one change)."""
    args, _ = _inputs(name, vdtype)
    ray_tile = CK.RAY_TILE_COHERENT if coherent else CK.RAY_TILE_INCOHERENT
    got = CK.pack_plain(*args, group=group, ray_tile=ray_tile)
    want = _parent_stages(*args, group, ray_tile)
    for field in CK.Packed._fields:
        a, b = getattr(got, field), getattr(want, field)
        if field in ("lo", "hi", "box_lo", "box_hi"):
            assert torch.equal(a, b), field
            b = b + 0.0
        assert _same_bits(a, b), field
    assert got.phi.shape[1] == -(-N_RAYS // ray_tile) * ray_tile
    if name == "zeros":                  # the case has zeros of both signs
        neg0 = torch.tensor(-0.0).view(torch.int32)
        assert bool((_bits(want.lo) == neg0).any())
        assert not bool((_bits(got.lo) == neg0).any())


@pytest.mark.parametrize("coherent", [False, True])
@pytest.mark.parametrize("group", [None, 1, 3])
@pytest.mark.parametrize("name", ["icosphere", "dog20k"])
def test_prepare_inputs_takes_the_packed_stages(name, group, coherent):
    """On CPU tensors `prepare_inputs` gives pack_plain's outputs, with the
    shift the mean ray origin (or the given one) and the prepass over the
    packed boxes; no kernel launch is counted."""
    args, _ = _inputs(name, torch.float32)
    v, f, fv, _, o, d = args
    before = (CK.counters.pack_launches, CK.counters.candidates_launches,
              CK.counters.launches)
    for shift in (None, torch.tensor([1.5, -2.0, 0.25])):
        inp = CK.prepare_inputs(o, d, v, f, fv, coherent=coherent,
                                group=group, shift=shift)
        ray_tile = (CK.RAY_TILE_COHERENT if coherent
                    else CK.RAY_TILE_INCOHERENT)
        sh = o.mean(dim=0) if shift is None else shift
        pk = CK.pack_plain(v, f, fv, sh, o, d, group=inp.group,
                           ray_tile=ray_tile)
        assert group is None or inp.group == group
        for field in ("phi", "inv", "coef", "lo", "hi"):
            assert _same_bits(getattr(inp, field), getattr(pk, field))
        T = pk.phi.shape[1] // ray_tile
        cand, count = CK.candidates_plain(pk.phi[6:9], pk.inv, pk.box_lo,
                                          pk.box_hi, pk.box_valid, T,
                                          tile=coherent)
        assert torch.equal(inp.cand, cand) and torch.equal(inp.count, count)
    assert (CK.counters.pack_launches, CK.counters.candidates_launches,
            CK.counters.launches) == before


def test_pack_dispatch_and_checks():
    """CPU tensors take the plain version (no launch counted, face_valid
    None is all valid, int32 faces and float64 rays as int64 and float32);
    pack_cuda refuses CPU tensors and the checks refuse wrong inputs."""
    args, _ = _inputs("cube", torch.float32)
    v, f, fv, shift, o, d = args
    before = CK.counters.pack_launches
    got = CK.pack(*args, group=4, ray_tile=128)
    want = CK.pack_plain(*args, group=4, ray_tile=128)
    for a, b in zip(got, want):
        assert _same_bits(a, b)
    assert CK.counters.pack_launches == before
    all_valid = CK.pack(v, f, None, shift, o, d, group=1, ray_tile=128)
    ones = CK.pack(v, f, torch.ones_like(fv), shift, o, d, group=1,
                   ray_tile=128)
    for a, b in zip(all_valid, ones):
        assert _same_bits(a, b)
    other = CK.pack(v, f.int(), fv, shift, o.double(), d.double(), group=4,
                    ray_tile=128)
    for a, b in zip(other, got):
        assert _same_bits(a, b)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        CK.pack_cuda(*args, group=1, ray_tile=128)
    bad = {
        "faces": (v, f.float(), fv, shift, o, d),
        "shift": (v, f, fv, shift.double(), o, d),
        "dirs": (v, f, fv, shift, o, d[:-1]),
        "vertices": (v.t(), f, fv, shift, o, d),
        "face_valid": (v, f, fv[:-1], shift, o, d),
    }
    for name, a in bad.items():
        with pytest.raises(ValueError, match=name):
            CK._check_pack_inputs(*a)
    with pytest.raises(ValueError, match="at least 1"):
        CK._pack_sizes(12, 10, 0, 128)
    assert CK._pack_sizes(12, 1000, 4, 128) == (4, 1, 8)
