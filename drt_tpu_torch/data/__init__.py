from drt_tpu_torch.data.masks import process_mask  # noqa: F401
from drt_tpu_torch.data.views import CaptureData, ViewBatch, stack_views  # noqa: F401
from drt_tpu_torch.data.synthetic import synthesize_capture  # noqa: F401
from drt_tpu_torch.data.captured import load_h5_capture  # noqa: F401
