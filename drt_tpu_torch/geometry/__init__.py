from drt_tpu_torch.geometry.vec import (  # noqa: F401
    dot3, reflect, refract, fresnel_dielectric, safe_normalize,
)
from drt_tpu_torch.geometry.mt import (  # noqa: F401
    moller_trumbore, moller_trumbore_verts,
)
from drt_tpu_torch.geometry.metrics import (  # noqa: F401
    face_areas, area_var, edge_var, corner_angles_and_normals,
    edge_face_normals, dihedral_cos,
)
from drt_tpu_torch.geometry.normals import vertex_normals  # noqa: F401
from drt_tpu_torch.geometry.laplacian import uniform_laplacian_smooth  # noqa: F401
