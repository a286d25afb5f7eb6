"""The train step in plain PyTorch: what decides whether the program's
steps are correct.

It follows the reconstruction's published semantics (the reference's
optim.py and DiffRender.py, which the port also follows) as one plain
autograd program over the live lanes only: the oracle is `oracle.py`'s
culled brute force, the bounce and the losses are torch expressions that
autograd differentiates, the silhouette sampler's gradient is written as a
surrogate of value zero, and the update is the optimizer's formula. It
imports nothing of the program and takes nothing that the program made:
the connectivity, the face order, the hits, the evidence and the solve are
worked out again here from the mesh file and the capture.

Float32 throughout, with TF32 off (`precision`). The two controls run it
one precision lower: with TF32 on, or with the ray path (each bounce's
arithmetic, the exit rays and the ray loss's residuals) in bfloat16
(`ray_dtype`).

This module is the reference of every configuration that has none of its
own. A configuration brings its own as port_bench/reference/<its name>.py
(`bench.reference_of` loads it by path, the configuration's file is not
touched); such a module may import the shared parts from this one,
mesh.py and oracle.py, and provides, as this one does:

- `precision(tf32)`: a context manager under which the steps run, with
  TF32 on for the control that asks for it;
- `init_state(mesh)`: the pass's fresh state of a `RefMesh`, a dict with
  at least "params" and "m" ([V,3]); the parameters' change is measured
  from its "params";
- `step(state, lr, mesh, views, ray_view, silh_views, cfg, fault=None,
  ray_dtype=None)`: one train step, (new state, loss, parts), parts
  holding "ray", "vh", "sm" and "lanes"; `ray_view` is an int, or a list
  of ints where the mix draws more than one ray view a step, whose ray
  terms are then averaged and whose lanes summed, as the program does;
  `fault` is None, "half" or "frozen", `ray_dtype` None or the control's
  bfloat16 (below);
- `update(state, g, lr, cfg)`: the optimizer's update of the state by the
  limited gradient g;
- `first_grad(m1, optimizer)`: the first step's gradient from the
  momentum after it;
- `grad_from_momentum(m_new, m_old, optimizer, momentum)`: a step's
  limited gradient from the momentum before and after it.
"""

from __future__ import annotations

import contextlib
import math

import torch

from port_bench.reference.mesh import RefMesh
from port_bench.reference.oracle import Scene, closest_hit

OFFSET_EPS = 1e-5          # the bounce's absolute nudge
OFFSET_REL = 1e-4          # and its relative one
DET_EPS = 1e-12


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products with TF32 on or off, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _normalize(v, eps=1e-20):
    return v / torch.sqrt(torch.clamp(_dot(v, v), min=eps))[..., None]


def refract_bounce(o, d, v0, v1, v2, ior, ext_ior):
    """One refraction at each lane's matched triangle (v0, v1, v2 [n,3]):
    (refracted [n] bool, False on total internal reflection; new origin,
    advanced to the hit and nudged along the new direction by
    max(OFFSET_REL * |t|, OFFSET_EPS), taken as a constant; new unit
    direction)."""
    e1, e2 = v1 - v0, v2 - v0
    p = _cross(d, e2)
    det = _dot(e1, p)
    inv = 1.0 / torch.where(torch.abs(det) > DET_EPS, det,
                            torch.full_like(det, DET_EPS))
    q = _cross(o - v0, e1)
    t = _dot(e2, q) * inv
    n = _normalize(_cross(e1, e2))
    wo = -d
    cos_i = torch.clamp(_dot(wo, n), -1.0, 1.0)
    entering = cos_i > 0
    ext = torch.full_like(cos_i, ext_ior)
    inn = torch.full_like(cos_i, ior)
    eta = torch.where(entering, ext, inn) / torch.where(entering, inn, ext)
    nf = torch.where(entering[:, None], n, -n)
    cc = _dot(nf, wo)
    s2t = eta * eta * torch.clamp(1.0 - cc * cc, min=0.0)
    tir = s2t >= 1.0
    ct = torch.sqrt(torch.clamp(1.0 - s2t, 1e-12, 1.0))
    wt = _normalize(eta[:, None] * d + (eta * cc - ct)[:, None] * nf)
    off = torch.clamp(OFFSET_REL * torch.abs(t), min=OFFSET_EPS).detach()
    return (torch.logical_not(tir), o + t[:, None] * d + off[:, None] * wt,
            wt)


def trace_exit(o, d, vertices, faces, scene: Scene, ior, ext_ior,
               ray_dtype=None):
    """Two refractions and the exit query of the lanes (o, d) [n,3]:
    (origin, direction, lanes, escaped, (face at bounce 1, at bounce 2))
    of the lanes that refracted twice, `lanes` their indices into the
    input, `escaped` True where the exit ray meets the mesh no more.
    `ray_dtype` (the control) runs each refraction in that type, its
    rays and triangles rounded to it and its results widened again."""
    lanes = torch.arange(o.shape[0], device=o.device)
    tris = []
    for _ in range(2):
        _, tid = closest_hit(o, d, scene)
        keep = torch.nonzero(tid >= 0)[:, 0]
        o, d, lanes, tid = o[keep], d[keep], lanes[keep], tid[keep]
        tris = [x[keep] for x in tris]
        tri = vertices[faces[tid]]
        if ray_dtype is None:
            ok, o, d = refract_bounce(o, d, tri[:, 0], tri[:, 1],
                                      tri[:, 2], ior, ext_ior)
        else:
            low = [x.to(ray_dtype) for x in (o, d, tri[:, 0], tri[:, 1],
                                             tri[:, 2])]
            ok, o, d = refract_bounce(*low, ior, ext_ior)
            o, d = o.to(vertices.dtype), d.to(vertices.dtype)
        keep = torch.nonzero(ok)[:, 0]
        o, d, lanes = o[keep], d[keep], lanes[keep]
        tris = [x[keep] for x in tris] + [tid[keep]]
    _, exit_id = closest_hit(o, d, scene)
    return o, d, lanes, exit_id < 0, tuple(tris)


def ray_loss(verts, mesh: RefMesh, scene, views, i, cfg, half=False,
             evidence=False, ray_dtype=None):
    """(loss, evidence, lanes) of view i: over the matting-valid lanes
    that refract twice and escape (`lanes` of them), the squared distance
    between the exit direction and the unit direction from the exit origin
    (constant) to the matted screen point. `half` plants a fault: every
    second valid lane left out and the sum scaled by the share kept.
    `evidence` is each vertex's count of counted lanes at both bounces
    (None unless asked for). `ray_dtype` runs the ray path in that type
    (`trace_exit`, and the residuals here)."""
    lanes = torch.nonzero(views.valid[i])[:, 0]
    n_all = lanes.shape[0]
    if half:
        lanes = lanes[0::2]
    o = views.origin[i, 0].expand(lanes.shape[0], 3)
    d = views.ray_dir[i][lanes]
    o2, d2, kept, esc, tris = trace_exit(o, d, verts, mesh.faces, scene,
                                         cfg["ior"], cfg["ext_ior"],
                                         ray_dtype)
    o2, d2, kept = o2[esc], d2[esc], kept[esc]
    sp = views.screen_pixel[i][lanes[kept]]
    if ray_dtype is not None:
        sp, o2, d2 = sp.to(ray_dtype), o2.to(ray_dtype), d2.to(ray_dtype)
    tx = sp - o2.detach()
    ln = torch.sqrt(torch.clamp(_dot(tx, tx), min=1e-20))
    df = d2 - tx / ln[:, None]
    loss = _dot(df, df).to(verts.dtype).sum()
    if half:
        loss = loss * (n_all / max(lanes.shape[0], 1))
    ev = None
    if evidence:
        ids = torch.cat([mesh.faces[t[esc]].reshape(-1) for t in tris])
        ev = torch.zeros(verts.shape[0], device=verts.device)
        ev.index_add_(0, ids, torch.ones_like(ids, dtype=ev.dtype))
    return loss, ev, int(kept.shape[0])


def _project(R, K, V):
    """World points [..., 3] to pixels [..., 2], camera depth constant."""
    ones = torch.ones(V.shape[:-1] + (1,), dtype=V.dtype, device=V.device)
    v_cam = torch.cat([V, ones], dim=-1) @ R.T
    v_cam = torch.cat([v_cam[..., :2], v_cam[..., 2:3].detach(),
                       v_cam[..., 3:]], dim=-1)
    v_pix = v_cam[..., :3] @ K.T
    return v_pix[..., :2] / v_pix[..., 2:3]


def silhouette_loss(verts, mesh: RefMesh, scene, views, i, budget):
    """(loss, silhouette edges) of view i: the edges whose two faces face
    the camera differently, the first `budget` in edge order, each sampled
    at its projected midpoint against the soft mask's 0.5 level. The
    sample's gradient moves both endpoints along the edge's screen normal N
    by the occupancy difference f across it (dE = -N f per unit of the
    sample's value), written as a surrogate of value 0."""
    cam = views.origin[i, 0]
    R, K = views.R[i], views.K[i]
    R_inv, K_inv = views.R_inv[i], views.K_inv[i]
    mask = views.mask[i]
    resy, resx = mask.shape
    tri = verts.detach()[mesh.faces[mesh.edge_faces]]         # [E,2,3,3]
    nrm = _cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0])
    side = _dot(nrm, cam - tri[:, :, 0]) > 0
    sel = torch.nonzero(torch.logical_xor(side[:, 0], side[:, 1]))[:, 0]
    count = sel.shape[0]
    sel = sel[:budget]
    k = sel.shape[0]
    E = _project(R, K, verts[mesh.edges[sel]])                # [k,2,2]
    Ed = E.detach()
    ax, ay, bx, by = Ed[:, 0, 0], Ed[:, 0, 1], Ed[:, 1, 0], Ed[:, 1, 1]
    sample = torch.stack([(ax + bx) * 0.5, (ay + by) * 0.5], dim=1)
    N = torch.stack([ay - by, bx - ax], dim=1)
    n_len = torch.linalg.norm(N, dim=1, keepdim=True)
    N_unit = N / torch.clamp(n_len, min=1e-12)
    f_point = torch.cat([sample + N_unit, sample - N_unit])
    ones = torch.ones_like(f_point[:, :1])
    cam_p = torch.cat([f_point, ones], dim=1) @ K_inv.T
    world = (torch.cat([cam_p, ones], dim=1) @ R_inv.T)[:, :3]
    _, tid = closest_hit(cam.expand(world.shape), world - cam, scene)
    occ = (tid >= 0).to(E.dtype)
    f = occ[:k] - occ[k:]
    pixel = sample.to(torch.int32)
    px, py = pixel[:, 0], pixel[:, 1]
    valid = ((torch.abs(f) > 1e-5) & (px >= 0) & (px < resx - 1)
             & (py >= 0) & (py < resy - 1))
    picked = mask[py.clamp(0, resy - 1).long(), px.clamp(0, resx - 1).long()]
    out = 0.5 + ((-N * f[:, None])[:, None, :] * (E - Ed)).sum(dim=(1, 2))
    diff = picked - out
    per = torch.sign(diff).detach() * diff
    return torch.where(valid, per, torch.zeros_like(per)).sum(), count


def smooth_loss(verts, mesh: RefMesh):
    """Sum over edges of -log(1 + cos) of the two faces' dihedral, the
    argument floored at 1e-12."""
    tri = verts[mesh.faces[mesh.edge_faces]]
    n = _normalize(_cross(tri[:, :, 1] - tri[:, :, 0],
                          tri[:, :, 2] - tri[:, :, 0]))
    cos = _dot(n[:, 0], n[:, 1])
    return -torch.log(torch.clamp(1.0 + cos, min=1e-12)).sum()


def ray_views_loss(verts, mesh, scene, views, ray_view, cfg, half=False,
                   evidence=False, ray_dtype=None):
    """`ray_loss` of the ray view ray_view (an int) or of each of the ray
    views ray_view (a list of ints): the mean of the views' ray terms, the
    sum of their evidence and of their lanes."""
    if isinstance(ray_view, int):
        return ray_loss(verts, mesh, scene, views, ray_view, cfg, half,
                        evidence, ray_dtype)
    rls, evs, lanes = zip(*(ray_loss(verts, mesh, scene, views, i, cfg, half,
                                     evidence, ray_dtype)
                            for i in ray_view))
    return (torch.stack(rls).mean(), sum(evs) if evidence else None,
            sum(lanes))


def total_loss(verts, mesh, views, ray_view, silh_views, cfg, w,
               half=False, evidence=False, ray_dtype=None):
    """(loss, parts, evidence) under weights w = (ray_w, vh_w, sm_w);
    ray_view an int or a list of ints (`ray_views_loss`)."""
    scene = Scene(verts.detach(), mesh.faces)
    resy = views.mask.shape[1]
    zero = verts.new_zeros(())
    rl, ev, lanes = (ray_views_loss(verts, mesh, scene, views, ray_view,
                                    cfg, half, evidence, ray_dtype)
                     if w[0] else (zero, None, 0))
    vh, edges = zero, 0
    if w[1]:
        for i in silh_views:
            l_i, c_i = silhouette_loss(verts, mesh, scene, views, i,
                                       cfg["silhouette_budget"])
            vh = vh + l_i
            edges = max(edges, c_i)
    sm = smooth_loss(verts, mesh) if w[2] else zero
    total = (w[0] * 217.5 / resy / resy * rl + w[1] * 217.5 / resy * vh
             + w[2] * mesh.mean_len / 10.0 * sm)
    parts = {"ray": rl.detach(), "vh": vh.detach(), "sm": sm.detach(),
             "edges": edges, "lanes": lanes}
    return total, parts, ev


def _laplacian(x, edges):
    deg = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    ones = torch.ones(edges.shape[0], dtype=x.dtype, device=x.device)
    deg.index_add_(0, edges[:, 0], ones).index_add_(0, edges[:, 1], ones)
    s = torch.zeros_like(x)
    s.index_add_(0, edges[:, 0], x[edges[:, 1]])
    s.index_add_(0, edges[:, 1], x[edges[:, 0]])
    return deg[:, None] * x - s


def sobolev_solve(b, mesh: RefMesh, lam, tol=1e-6, maxiter=64):
    """Conjugate gradients on (I + lam L) x = b from x = 0, L the graph
    Laplacian of the edges; stops once r.r <= tol^2 b.b or after maxiter
    trips."""
    x = torch.zeros_like(b)
    r = p = b
    gamma = _dot(r.reshape(-1), r.reshape(-1))
    atol2 = tol * tol * _dot(b.reshape(-1), b.reshape(-1))
    for _ in range(maxiter):
        if not bool(gamma > atol2):
            break
        ap = p + lam * _laplacian(p, mesh.edges)
        alpha = gamma / _dot(p.reshape(-1), ap.reshape(-1))
        x = x + alpha * p
        r = r - alpha * ap
        g_new = _dot(r.reshape(-1), r.reshape(-1))
        p = r + (g_new / gamma) * p
        gamma = g_new
    return x


def init_state(mesh: RefMesh):
    if mesh.vertices.dtype != torch.float32:
        raise ValueError("the reference and its controls are written for "
                         f"float32, not {mesh.vertices.dtype}")
    z = torch.zeros_like(mesh.vertices)
    return {"params": z, "m": z, "v": 0.0, "count": 0}


def step(state, lr, mesh: RefMesh, views, ray_view, silh_views, cfg,
         fault=None, ray_dtype=None):
    """One train step: (new state, loss, parts). ray_view an int or a
    list of ints (`ray_views_loss`), silh_views a list of ints. `fault`
    plants one: "half" (every second matting-valid lane of each ray view
    left out, the sum scaled back) or "frozen" (the parameters left
    unwritten while the momentum updates); `ray_dtype` runs the ray path
    in that type (a control)."""
    opt, pre = cfg["optimizer"], cfg["precond"]
    w = (cfg["ray_w"], cfg["vh_w"], cfg["sm_w"])

    def grad(weights, evidence=False):
        p = state["params"].detach().requires_grad_(True)
        loss, parts, ev = total_loss(mesh.vertices + p, mesh, views,
                                     ray_view, silh_views, cfg, weights,
                                     fault == "half", evidence, ray_dtype)
        (g,) = torch.autograd.grad(loss, p)
        return loss.detach(), parts, ev, g

    if pre == "h1":
        l_ray, parts, ev, g_ray = grad((w[0], 0.0, 0.0), evidence=True)
        l_reg, p_reg, _, g_reg = grad((0.0, w[1], w[2]))
        parts.update(vh=p_reg["vh"], sm=p_reg["sm"], edges=p_reg["edges"])
        c_bar = ev.sum() / torch.clamp((ev > 0).sum().to(ev.dtype), min=1.0)
        scale = (c_bar / (ev + 0.25 * torch.clamp(c_bar, min=1e-9))
                 if float(c_bar) > 0 else torch.zeros_like(ev))
        g = sobolev_solve(g_ray * scale[:, None] + g_reg, mesh,
                          cfg["precond_lambda"], maxiter=cfg["cg_iters"])
        loss = l_ray + l_reg
        clamp = cfg["grad_clamp"]
    elif pre == "none":
        loss, parts, _, g = grad(w)
        clamp = cfg["grad_clamp"] if opt == "sgd" else 0.0
    else:
        raise ValueError(f"the reference has no precond {pre!r}")
    g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
    if clamp:
        g = torch.clamp(g, -clamp, clamp)
    new = update(state, g, lr, cfg)
    if fault == "frozen":
        new["params"] = state["params"]
    return new, float(loss), {k: float(v) for k, v in parts.items()}


def update(state, g, lr, cfg):
    """The optimizer's update of state by the limited gradient g: sgd with
    the reference's momentum (optim.py:169), or uniform Adam, whose second
    moment is a running mean of each step's largest g^2."""
    params, m = state["params"], state["m"]
    if cfg["optimizer"] == "sgd":
        mu = cfg["momentum"]
        m = mu * m + g
        return dict(state, params=params - lr * (g + mu * m), m=m)
    if cfg["optimizer"] == "uadam":
        b1, b2, eps = 0.9, 0.999, 1e-8
        count = state["count"] + 1
        m = b1 * m + (1 - b1) * g
        m_hat = m / (1 - b1 ** count)
        v = b2 * state["v"] + (1 - b2) * float((g * g).max())
        denom = math.sqrt(v / (1 - b2 ** count)) + eps
        return dict(state, params=params - lr * m_hat / denom, m=m, v=v,
                    count=count)
    raise ValueError(f"the reference has no optimizer {cfg['optimizer']!r}")


def first_grad(m1, optimizer):
    """The gradient the optimizer took at step 1 from its momentum after
    it: m1 = g for sgd (from m = 0), (1 - b1) g for uniform Adam."""
    return m1 if optimizer == "sgd" else m1 / 0.1


def grad_from_momentum(m_new, m_old, optimizer, momentum):
    """The limited gradient a step took, from the momentum before and
    after it."""
    if optimizer == "sgd":
        return m_new - momentum * m_old
    return (m_new - 0.9 * m_old) / 0.1
