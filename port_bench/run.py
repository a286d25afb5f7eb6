"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout (see README.md). Needs a CUDA card; exits
with 3 and prints no result without one.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def fail(msg: str, code: int = 3):
    print(f"port_bench: {msg}", file=sys.stderr)
    sys.exit(code)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    build = os.path.join(ROOT, "build", "port_bench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    import torch
    from port_bench import bench
    cell, *_ = bench.resolve(args.workload, ROOT)
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; the benchmark runs only on the card")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{args.workload} needs {cell['chips']} cards, torch sees "
             f"{torch.cuda.device_count()}")
    try:
        import drt_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program is not in this checkout ({e})")
    out = bench.run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), T_START, ROOT)
    found = bench.forbidden_modules()
    if found:
        fail(f"the run loaded {found}", 4)
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    sys.stdout.flush()
    for k, c in out["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
