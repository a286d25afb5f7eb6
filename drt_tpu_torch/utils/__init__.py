from drt_tpu_torch.utils.metrics import MetricsLogger, profile_trace  # noqa: F401
