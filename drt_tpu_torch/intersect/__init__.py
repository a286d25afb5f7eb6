from drt_tpu_torch.intersect.api import Hits, get_intersect_fn  # noqa: F401
from drt_tpu_torch.intersect.brute import intersect_brute  # noqa: F401
from drt_tpu_torch.intersect.cuda_kernel import intersect_cuda  # noqa: F401
from drt_tpu_torch.intersect.culled import intersect_culled  # noqa: F401
