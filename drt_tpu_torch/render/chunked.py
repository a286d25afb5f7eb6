"""Ray chunking for the differentiable trace (port of
drt_tpu/render/chunked.py): memory scalability for batches above one view.

`chunked_sum` runs a per-ray reduction body over sequential ray chunks under
`torch.utils.checkpoint`: per-ray intermediates exist for one chunk at a
time in both the forward and the backward pass (the backward reruns each
chunk's body, oracle queries included), while the mesh-sized gradient
accumulates across chunks. The result is a partitioned version of the
unchunked sum (floating-point reassociation across chunk boundaries only).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.utils.checkpoint import checkpoint

# Auto policy: a full 1920x1080 view (2.07M rays) runs unchunked; anything
# bigger is processed in ~1M-ray chunks.
AUTO_THRESHOLD = 2 ** 21
AUTO_CHUNK = 2 ** 20


def auto_ray_chunk(num_rays: int) -> int:
    """Chunk size for `num_rays` under the auto policy (0 = no chunking)."""
    return AUTO_CHUNK if num_rays > AUTO_THRESHOLD else 0


def _tree_add(a, b):
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(_tree_add(x, y) for x, y in zip(a, b))
    return a + b


def chunked_sum(body: Callable, ray_args: Sequence[torch.Tensor],
                chunk: int, pad_values: Sequence):
    """Sum-over-rays reduction, evaluated chunk by chunk with
    rematerialization.

    body(*ray_args) must return a tensor, or a nest of tuples and dicts of
    tensors, of SUMS over the ray axis (scalars or mesh-sized accumulators
    such as per-vertex evidence) and must mask out rays itself via one of
    its inputs (padding lanes are filled with `pad_values`, so include a
    validity mask padded with False).

    chunk <= 0 or N <= chunk falls through to a single unchunked call."""
    n = ray_args[0].shape[0]
    if chunk <= 0 or n <= chunk:
        return body(*ray_args)
    t = -(-n // chunk)
    pad = t * chunk - n
    acc = None
    for i in range(t):
        args = [a[i * chunk:(i + 1) * chunk] for a in ray_args]
        if pad and i == t - 1:
            args = [torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]),
                                             pv)])
                    for a, pv in zip(args, pad_values)]
        out = checkpoint(body, *args, use_reentrant=False,
                         preserve_rng_state=False)
        acc = out if acc is None else _tree_add(acc, out)
    return acc
