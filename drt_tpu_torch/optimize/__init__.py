from drt_tpu_torch.optimize.losses import (  # noqa: F401
    LossWeights, ray_loss, silhouette_loss, smooth_loss, total_loss,
)
from drt_tpu_torch.optimize.schedules import (  # noqa: F401
    interp_linear, interp_reciprocal,
)
from drt_tpu_torch.optimize.loop import (  # noqa: F401
    default_silhouette_budget, find_resume_pass, limit_grad, make_train_step,
    optimize,
)
