"""Differentiable 3-vector optics (port of drt_tpu/geometry/vec.py).

Every sqrt/div input is clamped *before* use: `torch.where`, like
`jnp.where`, leaks NaN gradients from the untaken branch. Clamps are written
with `torch.maximum`/`torch.minimum` against tensors, whose backward splits
the gradient evenly at a tie exactly as JAX's `clip` does (`torch.clamp`
passes all of it), so degenerate inputs (cos_i = +-1) give the same
gradients as the JAX package.

The bounds are device tensors made once per (value, dtype, device) by
`constant` and kept: a Python number turned into a CUDA tensor on every
call is a copy from pageable host memory, which waits for the stream and
which a CUDA graph capture refuses.
"""

from __future__ import annotations

import torch

_CONSTANTS: dict = {}


def constant(value, dtype: torch.dtype, device) -> torch.Tensor:
    """`value` (a number, or a tuple of numbers for a 1-d tensor) as a
    tensor of `dtype` on `device`, the bits `torch.as_tensor` gives. Made
    once per (value, dtype, device) by device fills, never a host copy, and
    kept for every later call; callers must not write to it. On a card the
    first call for a value must come before any stream capture (a graph's
    warm-up makes it): a constant filled inside a capture would hold its
    value only once the graph has run."""
    device = torch.device(device)
    key = (repr(value), dtype, device)
    t = _CONSTANTS.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"constant {value!r} ({dtype}) first asked "
                               "for inside a CUDA graph capture: make it "
                               "before the capture (in its warm-up)")
        values = value if isinstance(value, tuple) else (value,)
        with torch.inference_mode(False):
            t = torch.empty(len(values), dtype=dtype, device=device)
            for i, v in enumerate(values):
                t[i].fill_(v)
        if not isinstance(value, tuple):
            t = t[0]
        _CONSTANTS[key] = t
    return t


def const_like(x: torch.Tensor, value) -> torch.Tensor:
    """`value` in x's dtype on x's device: a tensor cast, a number from
    `constant`."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=x.dtype, device=x.device)
    return constant(value, x.dtype, x.device)


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """`jnp.clip` with JAX's gradient convention at the bounds."""
    if lo is not None:
        x = torch.maximum(x, const_like(x, lo))
    if hi is not None:
        x = torch.minimum(x, const_like(x, hi))
    return x


def tree_sum(values: torch.Tensor, shape: tuple) -> torch.Tensor:
    """The sum (0-d) of values [N] in the fixed order of the kernels'
    reductions (csrc/cg.cu, csrc/bounce.cu): value i added, in ascending
    i, to +0 in thread i % T of T = prod(shape) threads; the threads laid
    out as `shape` (each a power of two), then a halving tree over each
    dimension from the last to the first (element i takes element i + h
    for h = n/2, ..., 1)."""
    threads = 1
    for n in shape:
        threads *= n
    rows = -(-values.shape[0] // threads)
    padded = torch.cat([values, values.new_zeros(rows * threads
                                                 - values.shape[0])])
    acc = values.new_zeros(threads)
    for row in padded.reshape(rows, threads):
        acc = acc + row
    acc = acc.reshape(shape)
    for dim in reversed(range(len(shape))):
        h = acc.shape[dim] // 2
        while h:
            acc = acc.narrow(dim, 0, h) + acc.narrow(dim, h, h)
            h //= 2
    return acc.reshape(())


def dot3(a: torch.Tensor, b: torch.Tensor, keepdims: bool = False):
    """Batched 3-vector dot product (reference DiffRender.py:24-29)."""
    out = torch.sum(a * b, dim=-1)
    return out[..., None] if keepdims else out


# Component arithmetic of the kernels' plain versions: a 3-vector as a tuple
# of its components, each product and sum a torch operation rounded on its
# own, in the order the csrc/*.cu kernels compute them.

def comp_dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def comp_cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def comp_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def components(x: torch.Tensor) -> tuple:
    """The columns of x [..., 3] as a tuple of three tensors."""
    return tuple(x.unbind(-1))


def safe_normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Normalize along the last axis; zero vectors map to zero, not NaN."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v / torch.sqrt(clip(n2, eps))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def reflect(wo: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of outgoing dir `wo` about normal `n`
    (reference DiffRender.py:31-33)."""
    return -wo + 2.0 * dot3(wo, n, keepdims=True) * n


def refract(wo: torch.Tensor, n: torch.Tensor, eta,
            compat_cos_from_incident: bool = False):
    """Snell refraction (reference `Refract`, DiffRender.py:35-49).

    wo: [...,3] unit vector toward the source; n: [...,3] unit normal on
    wo's side; eta: scalar or [...] etaI/etaT. Returns (tir [...] bool,
    wt [...,3]); TIR lanes carry a finite garbage direction.
    compat_cos_from_incident=True reproduces the reference's cosThetaT from
    sin²θI (DiffRender.py:42)."""
    eta = const_like(wo, eta)
    if eta.ndim:
        eta = eta[..., None]
    cos_i = dot3(n, wo, keepdims=True)
    sin2_i = clip(1.0 - cos_i * cos_i, 0.0)
    sin2_t = eta * eta * sin2_i
    tir = (sin2_t >= 1.0)[..., 0]
    # 1e-12 floor: sqrt(0) NaN-poisons the backward pass
    if compat_cos_from_incident:
        cos_t = torch.sqrt(clip(1.0 - sin2_i, 1e-12, 1.0))
    else:
        cos_t = torch.sqrt(clip(1.0 - sin2_t, 1e-12, 1.0))
    wt = eta * -wo + (eta * cos_i - cos_t) * n
    # explicit (non-detached) renormalization, as the reference does
    return tir, safe_normalize(wt)


def fresnel_dielectric(cos_i: torch.Tensor, eta_i, eta_t):
    """Fresnel reflectance (reference `FrDielectric`, DiffRender.py:51-61).
    cos_i >= 0. Returns (tir, R); R is meaningless (but finite) on TIR."""
    sin_i = torch.sqrt(clip(1.0 - cos_i * cos_i, 1e-12, 1.0))
    sin_t = sin_i * eta_i / eta_t
    tir = sin_t >= 1.0
    cos_t = torch.sqrt(clip(1.0 - sin_t * sin_t, 1e-12))
    denom_parl = eta_t * cos_i + eta_i * cos_t
    denom_perp = eta_i * cos_i + eta_t * cos_t
    r_parl = (eta_t * cos_i - eta_i * cos_t) / clip(denom_parl, 1e-12)
    r_perp = (eta_i * cos_i - eta_t * cos_t) / clip(denom_perp, 1e-12)
    R = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return tir, R
