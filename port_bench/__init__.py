"""The benchmark of `drt_tpu_torch`, the PyTorch and CUDA port, on the
card: its harness (run.py, bench.py), its inputs (capture.py, traffic.py,
meshio.py and data/), its yardstick (reference/, tracing.py, peaks.py,
metrics/) and its cells' files (configs/, traffic/, limits/). See
README.md."""
