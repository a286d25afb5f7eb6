"""Sobolev (Laplacian) gradient preconditioning for vertex optimization
(port of drt_tpu/optimize/precondition.py).

Per-vertex SGD fits high-frequency noise while barely moving low-frequency
shape modes. The remedy (Nicolet, Jacobson & Jakob, "Large Steps in Inverse
Rendering of Geometry", SIGGRAPH Asia 2021) reparameterizes the vertices as

    v = (I + lam * L)^{-1} u,

with L the combinatorial graph Laplacian (D - Adj) of the current mesh.
Optimizing u premultiplies the gradient by A^{-1} = (I + lam*L)^{-1} twice,
which amplifies smooth displacement modes over per-vertex noise.

The solve is a matrix-free conjugate gradient on the padded fixed-degree
neighbor table of MeshState; padded vertices have degree 0, so A = I on
those lanes. `cg` follows jax.scipy.sparse.linalg.cg step for step (from
x0, 0 by default; one inner product over the whole [Vp,C] array, stop once
r.r <= tol^2 b.b, at most `maxiter` trips), so both packages take the same
iterations. It runs the fixed number of trips with every update masked by a
device-side "done" flag: the early exit's result exactly, and no host
synchronisation per iteration. `sobolev_solve` differentiates as JAX's
custom_linear_solve does: A is symmetric, so the backward is the same CG
solve of the cotangent (from the same x0, which JAX also hands its
transpose solve, and which takes no gradient), not a backward through the
iterations.

On CUDA tensors every solve is one launch of a hand-written kernel,
csrc/cg.cu (`cg_cuda`): the whole solve in one thread-block cluster, the
trip count left on the device, through one of two routes that `cg_route`
picks from the sizes: "shared" (the solve's vectors and neighbour rows in
the cluster's shared memory, the matvec's gathers through distributed
shared memory) where its bytes fit, "global" (the vectors in global
memory) otherwise. Its plain version `cg_plain` is `cg` on
`ordered_matvec`: it rounds each operation as the kernel does and sums
every dot product in the kernel's fixed order (`ordered_dot`), so both
routes give the plain version's bits on the card. CPU tensors take the
plain version; a CUDA tensor never does (a failed build or launch raises).
"""

from __future__ import annotations

import torch

from drt_tpu_torch import kernels, spans
from drt_tpu_torch.geometry.vec import tree_sum


def laplacian_matvec(x: torch.Tensor, neighbors: torch.Tensor,
                     neighbor_valid: torch.Tensor) -> torch.Tensor:
    """Combinatorial Laplacian L = D - Adj applied to x [Vp,C].

    neighbors: [Vp,D] int64 (invalid entries clamped to 0),
    neighbor_valid: [Vp,D] bool."""
    nx = x[neighbors]                                        # [Vp,D,C]
    nx = torch.where(neighbor_valid[..., None], nx, torch.zeros_like(nx))
    deg = neighbor_valid.sum(dim=1).to(x.dtype)
    return deg[:, None] * x - nx.sum(dim=1)


def sobolev_matvec(x, neighbors, neighbor_valid, lam):
    """A x = (I + lam L) x."""
    return x + lam * laplacian_matvec(x, neighbors, neighbor_valid)


def sobolev_apply(v, neighbors, neighbor_valid, lam):
    """u = A v (the forward map; initializes u from mesh vertices)."""
    return sobolev_matvec(v, neighbors, neighbor_valid, lam)


# csrc/cg.cu's cluster, which fixes the order of every dot product: the flat
# vector's element e goes to thread e % CG_THREADS, each thread sums its
# products in ascending e, then halving trees over the 32 lanes of a warp,
# the CG_BLOCK // 32 warps of a CTA and the CG_CTAS CTAs.
CG_CTAS = 16
CG_BLOCK = 1024
CG_THREADS = CG_CTAS * CG_BLOCK


# csrc/cg.cu's shared route: a row holds at most CG_SHARED_MAX_D uint16
# neighbours (so Vp <= CG_SHARED_MAX_VP); p holds CG_SHARED_MAX_C elements a
# vertex (C <= 4); a thread holds r for at most CG_SHARED_CHUNKS[dtype]
# chunks in registers; a CTA's shared memory holds the reductions' head,
# p (each chunk's (CG_BLOCK - 1) // C + 2 vertex slots of 4 elements, and
# 4 zeros), Ap and p's uint16 index of each own element (a chunk of
# CG_BLOCK each) and CG_SHARED_ROW bytes a row, within CG_SHARED_BUDGET
# bytes, the H100's opt-in shared memory a block (`_check_lib` checks that
# the card gives it).
CG_ROUTES = ("global", "shared")
CG_SHARED_MAX_D = 8
CG_SHARED_MAX_VP = 65536
CG_SHARED_MAX_C = 4
CG_SHARED_CHUNKS = {torch.float32: 12, torch.float64: 4}
CG_SHARED_HEAD = 1024
CG_SHARED_ROW = 20
CG_SHARED_BUDGET = 232448


def cg_owner(e: int) -> tuple:
    """(CTA, slot) of flat element e in csrc/cg.cu's cluster: thread e %
    CG_THREADS owns it, so CTA k owns the CG_BLOCK-element chunks
    [j CG_THREADS + k CG_BLOCK, + CG_BLOCK), and e sits at slot j CG_BLOCK
    + e % CG_BLOCK there."""
    return ((e // CG_BLOCK) % CG_CTAS,
            (e // CG_THREADS) * CG_BLOCK + e % CG_BLOCK)


def cg_shared_rows(vp: int, c: int) -> int:
    """The rows of the shared route's CTA that holds the most: a row for
    every vertex with an element in one of the CTA's chunks (a vertex whose
    elements straddle two chunks has one in each)."""
    n = vp * c
    most = 0
    for k in range(CG_CTAS):
        rows = 0
        for s in range(k * CG_BLOCK, n, CG_THREADS):
            end = min(s + CG_BLOCK, n)
            rows += (end - 1) // c - s // c + 1
        most = max(most, rows)
    return most


def cg_shared_bytes(vp: int, c: int, d: int, dtype):
    """Bytes of shared memory a CTA of the shared route takes for b [vp, c]
    of `dtype` and a [vp, d] table (csrc/cg.cu's cg_shared_bytes), None
    where the route does not take the solve at any budget."""
    if dtype not in CG_SHARED_CHUNKS:
        return None
    chunks = -(-vp * c // CG_THREADS)
    if (not 0 <= vp <= CG_SHARED_MAX_VP or not 1 <= c <= CG_SHARED_MAX_C
            or not 0 <= d <= CG_SHARED_MAX_D
            or chunks > CG_SHARED_CHUNKS[dtype]):
        return None
    size = torch.empty((), dtype=dtype).element_size()
    spc = (CG_BLOCK - 1) // c + 1
    return (CG_SHARED_HEAD + (chunks * (spc + 1) + 1) * 4 * size
            + chunks * CG_BLOCK * (size + 2)
            + cg_shared_rows(vp, c) * CG_SHARED_ROW)


def cg_route(vp: int, c: int, d: int, dtype) -> str:
    """The route of csrc/cg.cu that a solve of b [vp, c] of `dtype` on a
    [vp, d] table takes: "shared" where `cg_shared_bytes` fits
    CG_SHARED_BUDGET (every float32 solve at Vp <= 65,536, C = 3, d <= 8),
    "global" otherwise."""
    need = cg_shared_bytes(vp, c, d, dtype)
    return "shared" if need is not None and need <= CG_SHARED_BUDGET \
        else "global"


def ordered_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u.v (0-d) summed in csrc/cg.cu's fixed order: each product rounded,
    then each thread's products added to +0 in order, then the trees over
    lanes, warps and CTAs."""
    return tree_sum((u * v).reshape(-1), (CG_CTAS, CG_BLOCK // 32, 32))


@torch.no_grad()
def cg(matvec, b: torch.Tensor, tol: float = 1e-5, maxiter: int = 64,
       x0=None):
    """Solve A x = b for symmetric positive definite A from x0 (zeros if
    None; see the module docstring). Returns (x, trips): trips is a 0-d
    int64 tensor on b's device, the iterations an early exit would have
    taken. Every dot product is `ordered_dot`, and every update a product
    and a sum each rounded on its own, in csrc/cg.cu's order."""
    if x0 is None:
        x = torch.zeros_like(b)
        r = p = b                      # b - A x0 with x0 = 0
    else:
        x = x0.detach()
        r = p = b - matvec(x)
    gamma = ordered_dot(r, r)
    atol2 = (tol * tol) * ordered_dot(b, b)
    went = []
    for _ in range(maxiter):
        go = gamma > atol2             # false once, false ever after
        ap = matvec(p)
        alpha = gamma / ordered_dot(p, ap)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        gamma_new = ordered_dot(r_new, r_new)
        p_new = r_new + (gamma_new / gamma) * p
        x = torch.where(go, x_new, x)
        r = torch.where(go, r_new, r)
        p = torch.where(go, p_new, p)
        gamma = torch.where(go, gamma_new, gamma)
        went.append(go)
    trips = (torch.stack(went).sum() if went
             else torch.zeros((), dtype=torch.int64, device=b.device))
    return x, trips


def ordered_matvec(neighbors, neighbor_valid, lam, dtype):
    """x -> A x = x + lam (deg x - sum of the valid neighbours' x), the
    neighbours added to +0 in table order as csrc/cg.cu adds them (an
    invalid entry adds +0, which leaves a sum from +0 as it is)."""
    deg = neighbor_valid.sum(dim=1).to(dtype)[:, None]
    pad = torch.logical_not(neighbor_valid)[..., None]

    def matvec(x):
        nx = x[neighbors].masked_fill(pad, 0.0)
        s = torch.zeros_like(x)
        for j in range(nx.shape[1]):
            s = s + nx[:, j]
        return x + lam * (deg * x - s)
    return matvec


def cg_plain(b, neighbors, neighbor_valid, lam, tol: float = 1e-5,
             maxiter: int = 64, x0=None):
    """Plain version of csrc/cg.cu: (x, trips) of `cg` on
    `ordered_matvec`."""
    return cg(ordered_matvec(neighbors, neighbor_valid, lam, b.dtype), b,
              tol=tol, maxiter=maxiter, x0=x0)


_INT32_MAX = 2 ** 31 - 1


def _check(b, neighbors, neighbor_valid, x0):
    dev = b.device
    kernels.expect("b", b, (None, None), kernels.FLOATS, dev)
    vp = b.shape[0]
    kernels.expect("neighbors", neighbors, (vp, None), torch.int64, dev)
    kernels.expect("neighbor_valid", neighbor_valid, tuple(neighbors.shape),
                   torch.bool, dev)
    kernels.expect("x0", x0, tuple(b.shape), b.dtype, dev)
    if max(b.numel(), neighbors.numel()) > _INT32_MAX:
        raise ValueError(f"{tuple(b.shape)} with {neighbors.shape[1]} "
                         "neighbours: beyond the kernel's int32 sizes")


# Sizes at which `_check_lib` holds the library's cg_shared_bytes to
# `cg_shared_bytes`: (vp, c, d, f64).
_SHARED_PROBES = ((0, 3, 8, 0), (1024, 3, 8, 0), (16384, 3, 8, 1),
                  (21845, 3, 8, 1), (21846, 3, 8, 1), (65536, 3, 8, 0),
                  (65536, 1, 4, 0), (65537, 3, 8, 0), (1000, 3, 9, 0),
                  (1000, 5, 8, 0))


@kernels.checks("cg", "cg_shared")
def _check_lib(lib):
    """csrc/cg.cu's summation order, a card that schedules both routes'
    clusters and gives the shared route its budget, and the shared route's
    sizes."""
    if (lib.cg_ctas(), lib.cg_block()) != (CG_CTAS, CG_BLOCK):
        raise RuntimeError(
            f"csrc/cg.cu sums over {lib.cg_ctas()} CTAs of "
            f"{lib.cg_block()} threads, the plain version over "
            f"{CG_CTAS} of {CG_BLOCK}")
    if not lib.cg_cluster_ready():
        raise RuntimeError(f"cg: the card schedules no cluster of "
                           f"{CG_CTAS} CTAs of {CG_BLOCK} threads")
    if lib.cg_shared_budget() < CG_SHARED_BUDGET:
        raise RuntimeError(
            f"cg: the card gives the shared route's CTAs "
            f"{lib.cg_shared_budget()} bytes of shared memory in a "
            f"cluster of {CG_CTAS}, cg_route plans for "
            f"{CG_SHARED_BUDGET}")
    for vp, c, d, f64 in _SHARED_PROBES:
        want = cg_shared_bytes(vp, c, d, torch.float64 if f64
                               else torch.float32)
        got = lib.cg_shared_bytes(vp, c, d, f64)
        if got != (-1 if want is None else want):
            raise RuntimeError(
                f"csrc/cg.cu's shared route takes {got} bytes for "
                f"{(vp, c, d, f64)}, cg_shared_bytes says {want}")


def cg_cuda(b, neighbors, neighbor_valid, lam, tol: float = 1e-5,
            maxiter: int = 64, x0=None, route=None):
    """Launch csrc/cg.cu on the current stream: (x, trips) as `cg_plain`
    gives them, bit for bit, in one launch. b [Vp,C] float32 or float64,
    neighbors [Vp,D] int64 (valid entries in [0, Vp)), neighbor_valid
    [Vp,D] bool, x0 like b or None; contiguous on one CUDA device. `route`
    ("global" or "shared") forces a route, `cg_route`'s by default; forcing
    "shared" where `cg_route` does not take it raises. Nothing waits on the
    host."""
    _check(b, neighbors, neighbor_valid, x0)
    vp, c = b.shape
    d = neighbors.shape[1]
    fits = cg_route(vp, c, d, b.dtype)
    route = fits if route is None else route
    if route not in CG_ROUTES:
        raise ValueError(f"route {route!r}: expected one of {CG_ROUTES}")
    if route == "shared" and fits != "shared":
        raise ValueError(f"the shared route does not take b {(vp, c)} "
                         f"{b.dtype} with {d} neighbours")
    kernels.need_cuda("cg_cuda", b)
    if maxiter < 0:
        raise ValueError(f"maxiter {maxiter} < 0")
    name = "cg_shared" if route == "shared" else "cg"
    lib = kernels.library(name)
    f64 = int(b.dtype == torch.float64)
    x = torch.empty_like(b)
    trips = torch.empty((), dtype=torch.int64, device=b.device)
    scratch = torch.empty(
        lib.cg_shared_scratch_bytes(vp, f64) if route == "shared"
        else lib.cg_scratch_bytes(vp, c, d, f64),
        dtype=torch.uint8, device=b.device)
    kernels.launch(
        name, b, ("cg_launches", f"cg_{route}_launches"),
        what=f"cg ({route} route)", b=b, x0=x0, f64=f64, nbr=neighbors,
        valid=neighbor_valid, vp=vp, c=c, d=d, lam=float(lam),
        tol2=float(tol) * float(tol), maxiter=int(maxiter), x=x, trips=trips,
        scratch=scratch)
    return x, trips


class _SobolevSolve(torch.autograd.Function):
    """v = A^{-1} u by CG; d/du is the same solve of the cotangent. Each
    solve is a `solve` span (spans.py); the adjoint's launches count in
    `kernels.counters.cg_adjoint_launches`."""

    @staticmethod
    def forward(ctx, u, neighbors, neighbor_valid, lam, maxiter, tol, x0):
        ctx.save_for_backward(neighbors, neighbor_valid)
        ctx.args = (lam, maxiter, tol, x0)
        with spans.span("solve", u):
            return _solve(u, neighbors, neighbor_valid, lam, maxiter, tol,
                          x0)

    @staticmethod
    def backward(ctx, g):
        neighbors, neighbor_valid = ctx.saved_tensors
        with spans.span("solve", g):
            x = _solve(g, neighbors, neighbor_valid, *ctx.args)
        if g.device.type == "cuda":
            kernels.counters.cg_adjoint_launches += 1
        return x, None, None, None, None, None, None


def _solve(u, neighbors, neighbor_valid, lam, maxiter, tol, x0=None):
    """The solve on u's device: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    u = u.detach().contiguous()
    if x0 is not None:
        x0 = x0.detach().contiguous()
    v, _ = kernels.on_device(u, cg_cuda, cg_plain)(
        u, neighbors.long().contiguous(), neighbor_valid.contiguous(), lam,
        tol=tol, maxiter=maxiter, x0=x0)
    return v


def sobolev_solve(u, neighbors, neighbor_valid, lam, maxiter: int = 64,
                  tol: float = 1e-6, x0=None):
    """v = A^{-1} u by CG from x0 (a warm start; zeros if None).
    Differentiable in u."""
    return _SobolevSolve.apply(u, neighbors, neighbor_valid, lam, maxiter,
                               tol, x0)
