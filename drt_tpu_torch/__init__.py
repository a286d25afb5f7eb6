"""drt_tpu_torch — the PyTorch/CUDA port of drt_tpu.

Same layout and function names as `drt_tpu`, so each module's counterpart
is found by path. Plain tensor code is PyTorch autograd; the hand-written
kernels in `csrc/` are built, bound, launched and counted by `kernels.py`
and wrapped, each beside its plain version, by six modules:
`intersect/cuda_kernel.py` (the oracle's `csrc/pack.cu`,
`csrc/candidates.cu` and `csrc/closest_hit.cu`, and `csrc/order.cu`, the
one-origin route's ray order), `geometry/scatter.py` (`csrc/scatter.cu`,
the row scatter-add), `optimize/precondition.py` (`csrc/cg.cu`, the
Sobolev CG solve), `render/bounce.py` (`csrc/bounce.cu`, a bounce's chain
and the ray loss's tail), `render/silhouette_kernels.py`
(`csrc/silhouette.cu`, a silhouette view's chain) and `spans.py`
(`csrc/span.cu`, the train step's device span markers).
Entry points that create tensors (`build_mesh_state`,
`stack_views`, `synthesize_capture`, `load_h5_capture`, `carve_occupancy`,
`optimize`, and the command line's `--device`) default to `"cuda"`; the
tests pass `"cpu"`, where every kernel wrapper runs its plain version.

Layer map:
    cli         the command line, `python -m drt_tpu_torch.cli`:
                reconstruct, evaluate, render, carve, remesh
    geometry/   differentiable optics and mesh metrics
    mesh/       PLY IO, topology extraction, padded mesh state
    intersect/  the non-differentiable hit oracle (brute / culled / cuda,
                and the Morton re-sort route for incoherent queries)
    render/     2-bounce refraction trace, silhouette edge sampling, cameras,
                ray chunking
    data/       view containers, the synthetic capture generator, the h5
                capture loader and writer (`captured`), and space carving
                of a first mesh from the silhouettes (`carve`: occupancy on
                the device, cleanup and surface nets on the host)
    optimize/   losses, schedules, preconditioners, the train step and the
                LOD loop (`optimize`)
    remesh/     host-side isotropic remeshing (numpy + the C++ core in
                native/) and Hausdorff evaluation
    utils/      metrics logger, profiler helper, image output (`images`)
    kernels     nvcc build, ctypes binding, the launch layer (one typed row
                a launch, `launch`, `expect`, `on_device`) and launch
                counters of csrc/*.cu
"""

import torch

# Full-precision float32 products on the card. TF32 keeps ~10 mantissa bits:
# the H100 form of the bf16 matrix-unit rounding that classified small
# triangles as misses in the JAX package (intersect/culled.py, the
# Precision.HIGHEST notes). Camera projections and the plain closest-hit
# twin both run float32 matmuls.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from drt_tpu_torch.config import HyperParams  # noqa: E402,F401
from drt_tpu_torch.intersect.api import Hits, get_intersect_fn  # noqa: E402,F401
from drt_tpu_torch.mesh.ply import load_ply, save_ply  # noqa: E402,F401
from drt_tpu_torch.mesh.state import MeshState, build_mesh_state  # noqa: E402,F401
