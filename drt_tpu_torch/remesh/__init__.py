from drt_tpu_torch.remesh.isotropic import isotropic_remesh  # noqa: F401
from drt_tpu_torch.remesh.hausdorff import (  # noqa: F401
    hausdorff_distance, point_mesh_distance,
)
from drt_tpu_torch.remesh.surface import SurfaceIndex  # noqa: F401
