"""Build the capture of one rig on the card and report what it costs:

    python3 port_bench/capture_stats.py --cache DIR --out FILE

The rig is RIG below, the Redmi rig (1920x1080) with 2 x 2 sub-pixel
rays (`capture.py`'s "supersample"), on the ring of 72 views about
dog_mid90k.ply that every committed configuration uses, with
dog-pointgray-parity's indices of refraction. It prints, and writes to
FILE as JSON: the capture's cache file, the seconds its build took, the
bytes of its .npz, the device bytes of its `Views`, its lanes a view and
the chunks of 2^20 lanes the port's step would trace a view in, the share
of valid lanes, the peak device memory, and the card. DIR holds the cache;
a capture already there is read, not built.
"""

import argparse
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BASE = "dog-pointgray-parity"   # the configuration whose mesh and ior it takes
RIG = {"name": "redmi", "resy": 1080, "resx": 1920, "num_views": 72,
       "fov_deg": 45.0, "cam_distance_factor": 3.5,
       "screen_distance_factor": 2.5, "elevation_deg": 10.0,
       "supersample": 2}
CHUNK = 2 ** 20          # the port's chunk of a ray view above 2^21 lanes


def stats(cfg: dict, device, cache: str) -> dict:
    """The capture of cfg built (or read) in the directory cache and loaded
    on device: what the module's docstring lists."""
    import torch
    from port_bench import capture
    from port_bench.meshio import load_mesh
    cuda = device.type == "cuda"
    if cuda:
        # the context and its allocator, which reading a capture from the
        # cache does not start, before the peak is reset below
        torch.zeros((), device=device)
    gt = load_mesh(ROOT, cfg["ground_truth"])
    path = os.path.join(cache, f"capture-{capture.cache_key(cfg)}.npz")
    built = not os.path.exists(path)
    t0 = time.perf_counter()
    capture.build_or_read(*gt, cfg, device, cache)
    build_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    views = capture.load(*gt, cfg, device, cache)
    if cuda:
        torch.cuda.synchronize(device)
    load_s = time.perf_counter() - t0
    lanes = views.valid.shape[1]
    valid = int(views.valid.sum())
    return {
        "cache_file": os.path.basename(path), "built": built,
        "build_s": build_s, "load_s": load_s,
        "npz_bytes": os.path.getsize(path),
        "views_device_bytes": sum(t.numel() * t.element_size()
                                  for t in views),
        "views_device_bytes_by_field": {
            k: t.numel() * t.element_size()
            for k, t in views._asdict().items()},
        "load_memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                   if cuda else None),
        "lanes_a_view": lanes, "chunks_a_view": math.ceil(lanes / CHUNK),
        "valid_lanes": valid, "valid_share": valid / views.valid.numel(),
        "mask_hit_share": float((views.mask == 1.0).float().mean()),
        "device": (torch.cuda.get_device_name(device) if cuda
                   else device.type)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from port_bench import bench
    if not torch.cuda.is_available():
        sys.exit("capture_stats: torch sees no CUDA device")
    cfg = bench.read_json(os.path.join(HERE, "configs", f"{BASE}.json"))
    cfg = dict(cfg, name="redmi-supersample-2", rig=RIG)
    out = stats(cfg, torch.device("cuda", 0), args.cache)
    text = json.dumps(out, indent=1)
    print(text)
    with open(args.out, "w") as fh:
        fh.write(text + "\n")


if __name__ == "__main__":
    main()
