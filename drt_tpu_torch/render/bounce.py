"""The per-lane chain of a refraction bounce and the ray loss's per-lane
tail (four hand-written CUDA kernels, csrc/bounce.cu), with their plain
versions and autograd Functions.

`bounce_chain(origin, direction, g9, hit, active, safe_id, park, ...)` is
what the JAX package's `_bounce` does after its oracle query
(drt_tpu/render/trace.py:207-260): the Moller-Trumbore re-intersection of
each lane with its matched triangle (`moller_trumbore_verts`), the Snell
refraction (`refract_ray`), the new active mask (hit and not totally
reflected), the new rays, and the parked ray on every dead lane. g9 [N,9]
holds each lane's triangle (`_gather_tri9`, which stays in front of the
chain so that the vertex gradient takes its scatter routes unchanged).
Returns (o_out, d_out, active_out, face id where active else 0);
differentiable in origin, direction and g9.

`ray_tail(origin, direction, screen_pixel, lane_valid, active, exit_hit,
huber)` is the ray loss's tail (drt_tpu/optimize/losses.py:77-105 with
drt_tpu/render/trace.py:317-322): over the lanes that count (lane_valid
and active and not exit_hit), the squared difference between the exit
direction and the unit direction from the (detached) exit origin to the
matted screen point, through the Huber branch where huber != 0, summed
over lanes. Differentiable in direction.

On CPU tensors each runs its plain version (`bounce_plain`,
`bounce_plain_backward`, `ray_tail_plain`, `ray_tail_plain_backward`):
torch operations on the lanes' components in csrc/bounce.cu's order, each
rounded on its own, and every backward written out by hand. On CUDA
tensors each launches its kernel, which gives the plain version's bits, or
raises; nothing falls back. The plain versions restate
`geometry.mt.moller_trumbore_verts`, `render.trace.refract_ray` and
`geometry.vec.safe_normalize` (whose clamps split a cotangent in halves at
a tie, as JAX's clip does) and the tail of `optimize.losses.ray_loss`;
tests/test_torch_bounce.py holds them to those and to the JAX package.
"""

from __future__ import annotations

import torch

from drt_tpu_torch import kernels
from drt_tpu_torch.geometry.vec import (comp_cross as _cross, comp_dot as _dot,
                                        comp_sub as _sub, components as _cols,
                                        const_like, tree_sum)

OFFSET_REL = 1e-4             # refract_ray's relative nudge
DET_EPS = 1e-12               # moller_trumbore_verts' det guard
PARK_DIRECTION = -0.57735027  # each component of a parked ray's direction
# csrc/bounce.cu's launch shapes: threads a block of the bounce kernels,
# and the tail's threads a block and blocks, which fix its sum's order.
BOUNCE_BLOCK = 256
RAY_TAIL_BLOCK = 256
RAY_TAIL_BLOCKS = 1024
RAY_TAIL_THREADS = RAY_TAIL_BLOCK * RAY_TAIL_BLOCKS


# -- the lanes' arithmetic, on tuples of [N] components -----------------------

def _gate_max(x, c, g, zero, half):
    """The cotangent g of torch.maximum(x, c) taken into x: g, g / 2 at a
    tie, 0 where c was taken."""
    return torch.where(x < c, zero, torch.where(x == c, g * half, g))


def _gate_min(x, c, g, zero, half):
    """The same through torch.minimum(x, c)."""
    return torch.where(x > c, zero, torch.where(x == c, g * half, g))


class _Consts:
    """The numbers of the chain as 0-d tensors of the lanes' type (a host
    number rounded to that type once, as the kernel rounds it)."""

    def __init__(self, like, int_ior=1.0, ext_ior=1.0, offset_eps=0.0):
        def c(v):
            return const_like(like, v)
        self.zero, self.half, self.one = c(0.0), c(0.5), c(1.0)
        self.m_one, self.eps20, self.eps12, self.eps24 = (c(-1.0), c(1e-20),
                                                          c(1e-12), c(1e-24))
        self.det_eps, self.rel = c(DET_EPS), c(OFFSET_REL)
        self.inn, self.ext, self.off_eps = (c(int_ior), c(ext_ior),
                                            c(offset_eps))


def _lane_forward(o, d, v, k: _Consts, compat: bool) -> dict:
    """csrc/bounce.cu's `lane_forward` on component tuples: every value the
    backward reads, by the kernel's names."""
    L = {}
    v0, v1, v2 = v[0:3], v[3:6], v[6:9]
    L["e1"], L["e2"] = _sub(v1, v0), _sub(v2, v0)
    L["tv"] = _sub(o, v0)
    L["p"] = _cross(d, L["e2"])
    det = _dot(L["e1"], L["p"])
    L["ok"] = torch.abs(det) > k.det_eps
    L["inv"] = k.one / torch.where(L["ok"], det, k.det_eps)
    L["q"] = _cross(L["tv"], L["e1"])
    L["tq"] = _dot(L["e2"], L["q"])
    L["t"] = L["tq"] * L["inv"]
    L["nc"] = _cross(L["e1"], L["e2"])
    L["nn2"] = _dot(L["nc"], L["nc"])
    L["nl"] = torch.sqrt(torch.maximum(L["nn2"], k.eps20))
    L["n"] = tuple(x / L["nl"] for x in L["nc"])
    wo = tuple(-x for x in d)
    cos_i = torch.minimum(torch.maximum(_dot(wo, L["n"]), k.m_one), k.one)
    ent = L["entering"] = cos_i > k.zero
    eta_i = torch.where(ent, k.ext, k.inn)
    eta_t = torch.where(ent, k.inn, k.ext)
    L["nf"] = tuple(torch.where(ent, x, -x) for x in L["n"])
    L["eta"] = eta_i / eta_t
    L["cc"] = _dot(L["nf"], wo)
    L["u"] = k.one - L["cc"] * L["cc"]
    s2i = torch.maximum(L["u"], k.zero)
    s2t = (L["eta"] * L["eta"]) * s2i
    L["tir"] = s2t >= k.one
    L["rad"] = k.one - (s2i if compat else s2t)
    L["radm"] = torch.maximum(L["rad"], k.eps12)
    L["ct"] = torch.sqrt(torch.minimum(L["radm"], k.one))
    L["k"] = L["eta"] * L["cc"] - L["ct"]
    L["w"] = tuple(L["eta"] * x + L["k"] * y for x, y in zip(d, L["nf"]))
    L["ww"] = _dot(L["w"], L["w"])
    L["wl"] = torch.sqrt(torch.maximum(L["ww"], k.eps20))
    L["wt"] = tuple(x / L["wl"] for x in L["w"])
    L["off"] = (k.off_eps if compat else
                torch.maximum(k.rel * torch.abs(L["t"]), k.off_eps))
    return L


# -- the plain versions -------------------------------------------------------

def bounce_plain(origin, direction, g9, hit, active, safe_id, park,
                 int_ior, ext_ior, offset_eps, compat: bool = False):
    """Plain version of csrc/bounce.cu's forward: (o_out, d_out,
    active_out, tri_out) as `bounce_chain` returns them."""
    k = _Consts(origin, int_ior, ext_ior, offset_eps)
    o, d = _cols(origin), _cols(direction)
    L = _lane_forward(o, d, _cols(g9), k, compat)
    alive = active & hit & torch.logical_not(L["tir"])
    new_o = [(x + L["t"] * y) + L["off"] * z
             for x, y, z in zip(o, d, L["wt"])]
    park_d = const_like(direction, PARK_DIRECTION)
    o_out = torch.stack([torch.where(alive, x, park[j])
                         for j, x in enumerate(new_o)], dim=1)
    d_out = torch.stack([torch.where(alive, x, park_d) for x in L["wt"]],
                        dim=1)
    return o_out, d_out, alive, torch.where(alive, safe_id,
                                            torch.zeros_like(safe_id))


def bounce_plain_backward(origin, direction, g9, alive, go, gd, int_ior,
                          ext_ior, offset_eps, compat: bool = False,
                          need_origin: bool = True,
                          need_direction: bool = True):
    """Plain version of csrc/bounce.cu's backward: (d_origin, d_direction,
    dg9) for the cotangents go of o_out and gd of d_out (either may be
    None: its path is skipped). d_origin is None unless need_origin and go
    is given, d_direction None unless need_direction."""
    if go is None and gd is None:
        raise ValueError("bounce backward: no cotangent")
    k = _Consts(origin, int_ior, ext_ior, offset_eps)
    o, d = _cols(origin), _cols(direction)
    L = _lane_forward(o, d, _cols(g9), k, compat)
    z, h = k.zero, k.half
    g_o = _cols(go) if go is not None else None
    g_d = _cols(gd) if gd is not None else None
    if g_d is not None and g_o is not None:
        gwt = tuple(x + L["off"] * y for x, y in zip(g_d, g_o))
    elif g_d is not None:
        gwt = g_d
    else:
        gwt = tuple(L["off"] * y for y in g_o)
    wl, nl = L["wl"], L["nl"]
    gwl = -(_dot(gwt, L["wt"]) / wl)
    gww = _gate_max(L["ww"], k.eps20, gwl / (wl + wl), z, h)
    gww2 = gww + gww
    gw = tuple(x / wl + gww2 * y for x, y in zip(gwt, L["w"]))
    if g_o is not None:
        gdir = [L["t"] * x + L["eta"] * y for x, y in zip(g_o, gw)]
    else:
        gdir = [L["eta"] * y for y in gw]
    gk = _dot(gw, L["nf"])
    gnf = [L["k"] * x for x in gw]
    gcc = L["eta"] * gk
    gr = _gate_max(L["rad"], k.eps12,
                   _gate_min(L["radm"], k.one, (-gk) / (L["ct"] + L["ct"]),
                             z, h), z, h)
    gs2i = -gr if compat else (L["eta"] * L["eta"]) * (-gr)
    gu = _gate_max(L["u"], z, gs2i, z, h)
    gcc = gcc - (gu + gu) * L["cc"]
    for j in range(3):
        gnf[j] = gnf[j] - gcc * d[j]
        gdir[j] = gdir[j] - gcc * L["nf"][j]
    gn = tuple(torch.where(L["entering"], x, -x) for x in gnf)
    gnl = -(_dot(gn, L["n"]) / nl)
    gnn = _gate_max(L["nn2"], k.eps20, gnl / (nl + nl), z, h)
    gnn2 = gnn + gnn
    gnc = tuple(x / nl + gnn2 * y for x, y in zip(gn, L["nc"]))
    ge1 = list(_cross(L["e2"], gnc))
    ge2 = list(_cross(gnc, L["e1"]))
    gtv = None
    if g_o is not None:
        gt = _dot(g_o, d)
        gtq = gt * L["inv"]
        ginv = gt * L["tq"]
        gq = []
        for j in range(3):
            ge2[j] = ge2[j] + gtq * L["q"][j]
            gq.append(gtq * L["e2"][j])
        gtv = _cross(L["e1"], gq)
        c = _cross(gq, L["tv"])
        ge1 = [x + y for x, y in zip(ge1, c)]
        gds = -(ginv * (L["inv"] * L["inv"]))
        gdet = torch.where(L["ok"], gds, z)
        gp = []
        for j in range(3):
            ge1[j] = ge1[j] + gdet * L["p"][j]
            gp.append(gdet * L["e1"][j])
        c = _cross(L["e2"], gp)
        gdir = [x + y for x, y in zip(gdir, c)]
        c = _cross(gp, d)
        ge2 = [x + y for x, y in zip(ge2, c)]
        gorg = [x + y for x, y in zip(g_o, gtv)]
    gv0 = []
    for j in range(3):
        s = ge1[j] + ge2[j]
        if gtv is not None:
            s = s + gtv[j]
        gv0.append(-s)

    def out(cols):
        return torch.where(alive[:, None], torch.stack(cols, dim=1), z)
    dg9 = out([*gv0, *ge1, *ge2])
    d_origin = out(gorg) if need_origin and g_o is not None else None
    d_direction = out(gdir) if need_direction else None
    return d_origin, d_direction, dg9


def _tail_lanes(origin, direction, screen_pixel, k: _Consts, huber: float):
    """csrc/bounce.cu's `tail_forward` on every lane: (df, s, r)."""
    tx = _sub(_cols(screen_pixel), _cols(origin))
    ln = torch.sqrt(torch.maximum(_dot(tx, tx), k.eps20))
    df = tuple(x - y / ln for x, y in zip(_cols(direction), tx))
    s = _dot(df, df)
    r = torch.sqrt(torch.maximum(s, k.eps24)) if huber != 0 else None
    return df, s, r


def tail_sum(values: torch.Tensor) -> torch.Tensor:
    """The sum (0-d) of values [N] in csrc/bounce.cu's fixed order: value
    i added, in ascending i, to +0 in thread i % RAY_TAIL_THREADS, then
    the halving tree over each block's threads and over the blocks."""
    return tree_sum(values, (RAY_TAIL_BLOCKS, RAY_TAIL_BLOCK))


def ray_tail_plain(origin, direction, screen_pixel, lane_valid, active,
                   exit_hit, huber: float = 0.0):
    """Plain version of csrc/bounce.cu's tail forward: the loss (0-d)."""
    k = _Consts(direction)
    _, s, r = _tail_lanes(origin, direction, screen_pixel, k, huber)
    if huber != 0:
        hub = const_like(s, huber)
        s = torch.where(r <= hub, s,
                        const_like(s, 2.0 * huber) * r
                        - const_like(s, huber * huber))
    w = lane_valid & active & torch.logical_not(exit_hit)
    return tail_sum(torch.where(w, s, k.zero))


def ray_tail_plain_backward(origin, direction, screen_pixel, lane_valid,
                            active, exit_hit, huber, g):
    """Plain version of csrc/bounce.cu's tail backward: d_direction [N,3]
    for the loss's cotangent g (0-d)."""
    k = _Consts(direction)
    df, s, r = _tail_lanes(origin, direction, screen_pixel, k, huber)
    gs = g.expand(s.shape)
    if huber != 0:
        gm = (const_like(s, 2.0 * huber) * g) / (r + r)
        gs = torch.where(r <= const_like(s, huber), gs,
                         _gate_max(s, k.eps24, gm, k.zero, k.half))
    g2 = gs + gs
    w = lane_valid & active & torch.logical_not(exit_hit)
    return torch.where(w[:, None], torch.stack([g2 * x for x in df], dim=1),
                       k.zero)


# -- the kernels' wrappers ----------------------------------------------------

@kernels.checks("bounce", "bounce_backward", "ray_tail", "ray_tail_backward")
def _check_lib(lib):
    """csrc/bounce.cu's launch shapes, which fix the tail's summation
    order."""
    got = (lib.bounce_block(), lib.ray_tail_block(), lib.ray_tail_blocks())
    want = (BOUNCE_BLOCK, RAY_TAIL_BLOCK, RAY_TAIL_BLOCKS)
    if got != want:
        raise RuntimeError(f"csrc/bounce.cu launches (bounce block, tail "
                           f"block, tail blocks) {got}, the plain version "
                           f"sums as {want}")


def _check(what, like, **tensors):
    """Raise unless like is [N,3] float32 or float64 on a CUDA device and
    each tensor (name: (tensor or None, shape, dtype or None for like's))
    is as `kernels.expect` wants it on like's device."""
    kernels.expect(f"{what}: rays", like, (None, 3), kernels.FLOATS,
                   like.device)
    for name, (t, shape, dtype) in tensors.items():
        kernels.expect(f"{what}: {name}", t, shape,
                       like.dtype if dtype is None else dtype, like.device)
    kernels.need_cuda(what, like)


def bounce_cuda(origin, direction, g9, hit, active, safe_id, park, int_ior,
                ext_ior, offset_eps, compat: bool = False):
    """Launch csrc/bounce.cu's forward on the current stream: what
    `bounce_plain` gives, bit for bit. Nothing waits on the host."""
    n = origin.shape[0]
    _check("bounce_cuda", origin, origin=(origin, (n, 3), None),
           direction=(direction, (n, 3), None), g9=(g9, (n, 9), None),
           hit=(hit, (n,), torch.bool), active=(active, (n,), torch.bool),
           safe_id=(safe_id, (n,), torch.int64), park=(park, (3,), None))
    o_out, d_out = torch.empty_like(origin), torch.empty_like(direction)
    alive = torch.empty(n, dtype=torch.bool, device=origin.device)
    tri = torch.empty(n, dtype=torch.int64, device=origin.device)
    kernels.launch(
        "bounce", origin, ("bounce_launches",) if n else (), org=origin,
        dir=direction, g9=g9, hit=hit, active=active, safe_id=safe_id,
        park_o=park, n=n, f64=origin.dtype == torch.float64,
        int_ior=float(int_ior), ext_ior=float(ext_ior),
        offset_eps=float(offset_eps), compat=bool(compat), o_out=o_out,
        d_out=d_out, act_out=alive, tri_out=tri)
    return o_out, d_out, alive, tri


def bounce_cuda_backward(origin, direction, g9, alive, go, gd, int_ior,
                         ext_ior, offset_eps, compat: bool = False,
                         need_origin: bool = True,
                         need_direction: bool = True):
    """Launch csrc/bounce.cu's backward: what `bounce_plain_backward`
    gives, bit for bit."""
    n = origin.shape[0]
    if go is None and gd is None:
        raise ValueError("bounce backward: no cotangent")
    _check("bounce_cuda_backward", origin, origin=(origin, (n, 3), None),
           direction=(direction, (n, 3), None), g9=(g9, (n, 9), None),
           alive=(alive, (n,), torch.bool), go=(go, (n, 3), None),
           gd=(gd, (n, 3), None))
    need_origin = need_origin and go is not None
    d_origin = torch.empty_like(origin) if need_origin else None
    d_direction = torch.empty_like(direction) if need_direction else None
    dg9 = torch.empty_like(g9)
    kernels.launch(
        "bounce_backward", origin,
        ("bounce_launches", "bounce_backward_launches") if n else (),
        org=origin, dir=direction, g9=g9, alive=alive, go=go, gd=gd, n=n,
        f64=origin.dtype == torch.float64, int_ior=float(int_ior),
        ext_ior=float(ext_ior), offset_eps=float(offset_eps),
        compat=bool(compat), d_org=d_origin, d_dir=d_direction, dg9=dg9)
    return d_origin, d_direction, dg9


def _tail_args(what, origin, direction, screen_pixel, lane_valid, active,
               exit_hit, huber, g=None):
    """The tail launches' inputs by their signature names, checked."""
    n = direction.shape[0]
    _check(what, direction, origin=(origin, (n, 3), None),
           direction=(direction, (n, 3), None),
           screen_pixel=(screen_pixel, (n, 3), None),
           lane_valid=(lane_valid, (n,), torch.bool),
           active=(active, (n,), torch.bool),
           exit_hit=(exit_hit, (n,), torch.bool), g=(g, (), None))
    return dict(org=origin, dir=direction, sp=screen_pixel,
                lane_valid=lane_valid, active=active, exit_hit=exit_hit, n=n,
                f64=direction.dtype == torch.float64, huber=float(huber))


def ray_tail_cuda(origin, direction, screen_pixel, lane_valid, active,
                  exit_hit, huber: float = 0.0):
    """Launch csrc/bounce.cu's tail forward: the loss `ray_tail_plain`
    gives, bit for bit (a 0-d tensor on the card; nothing waits)."""
    args = _tail_args("ray_tail_cuda", origin, direction, screen_pixel,
                      lane_valid, active, exit_hit, huber)
    like = dict(dtype=direction.dtype, device=direction.device)
    loss = torch.empty((), **like)
    kernels.launch(
        "ray_tail", direction, ("ray_tail_launches",), loss=loss,
        partials=torch.empty(RAY_TAIL_BLOCKS, **like),
        counter=torch.zeros(1, dtype=torch.int32, device=direction.device),
        **args)
    return loss


def ray_tail_cuda_backward(origin, direction, screen_pixel, lane_valid,
                           active, exit_hit, huber, g):
    """Launch csrc/bounce.cu's tail backward: what
    `ray_tail_plain_backward` gives, bit for bit."""
    args = _tail_args("ray_tail_cuda_backward", origin, direction,
                      screen_pixel, lane_valid, active, exit_hit, huber, g)
    d_direction = torch.empty_like(direction)
    kernels.launch(
        "ray_tail_backward", direction,
        ("ray_tail_launches", "ray_tail_backward_launches")
        if args["n"] else (), g=g, d_dir=d_direction, **args)
    return d_direction


# -- the autograd Functions ---------------------------------------------------

class _BounceChain(torch.autograd.Function):
    """The chain of a bounce after its oracle query (see `bounce_chain`):
    one kernel forward, one backward, which recomputes the lanes' forward
    from the saved inputs."""

    @staticmethod
    def forward(ctx, origin, direction, g9, hit, active, safe_id, park,
                int_ior, ext_ior, offset_eps, compat):
        args = (int_ior, ext_ior, offset_eps, compat)
        fn = kernels.on_device(origin, bounce_cuda, bounce_plain)
        o_out, d_out, alive, tri = fn(origin, direction, g9, hit, active,
                                      safe_id, park, *args)
        ctx.mark_non_differentiable(alive, tri)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(origin, direction, g9, alive)
        ctx.args = args
        return o_out, d_out, alive, tri

    @staticmethod
    def backward(ctx, go, gd, _ga, _gt):
        origin, direction, g9, alive = ctx.saved_tensors
        need_o, need_d, need_g = ctx.needs_input_grad[:3]
        if go is None and gd is None:
            return (None,) * 11
        fn = kernels.on_device(origin, bounce_cuda_backward,
                               bounce_plain_backward)
        d_o, d_d, dg9 = fn(
            origin, direction, g9, alive,
            None if go is None else go.contiguous(),
            None if gd is None else gd.contiguous(), *ctx.args,
            need_origin=need_o, need_direction=need_d)
        return (d_o, d_d, dg9 if need_g else None) + (None,) * 8


def bounce_chain(origin, direction, g9, hit, active, safe_id, park,
                 int_ior: float, ext_ior: float, offset_eps: float,
                 compat: bool = False):
    """(o_out, d_out, active_out, tri_out) of one bounce after its oracle
    query (see the module docstring). origin, direction [N,3] and g9 [N,9]
    of one float type; hit and active [N] bool; safe_id [N] int64 (the
    matched face where hit, else 0); park [3] the parked rays' origin
    (render.trace._park_rays)."""
    return _BounceChain.apply(
        origin.contiguous(), direction.contiguous(), g9.contiguous(), hit,
        active, safe_id, park, float(int_ior), float(ext_ior),
        float(offset_eps), bool(compat))


class _RayLossTail(torch.autograd.Function):
    """The ray loss's per-lane tail and its sum (see `ray_tail`): one
    kernel forward, one backward."""

    @staticmethod
    def forward(ctx, direction, origin, screen_pixel, lane_valid, active,
                exit_hit, huber):
        fn = kernels.on_device(direction, ray_tail_cuda, ray_tail_plain)
        loss = fn(origin, direction, screen_pixel, lane_valid, active,
                  exit_hit, huber)
        ctx.save_for_backward(direction, origin, screen_pixel, lane_valid,
                              active, exit_hit)
        ctx.huber = huber
        return loss

    @staticmethod
    def backward(ctx, g):
        direction, origin, screen_pixel, lane_valid, active, exit_hit = \
            ctx.saved_tensors
        fn = kernels.on_device(direction, ray_tail_cuda_backward,
                               ray_tail_plain_backward)
        d_direction = fn(origin, direction, screen_pixel, lane_valid, active,
                         exit_hit, ctx.huber, g.contiguous())
        return (d_direction,) + (None,) * 6


def ray_tail(origin, direction, screen_pixel, lane_valid, active, exit_hit,
             huber: float = 0.0):
    """The ray loss of one batch (0-d; see the module docstring): origin,
    direction and screen_pixel [N,3] of one float type, the masks [N]
    bool. Differentiable in direction; the origin is taken detached."""
    return _RayLossTail.apply(
        direction.contiguous(), origin.detach().contiguous(),
        screen_pixel.contiguous(), lane_valid, active, exit_hit,
        float(huber))
