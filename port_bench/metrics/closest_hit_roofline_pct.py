"""closest_hit_roofline_pct: the least time the step's closest-hit queries
need, as a share of `closest_hit_kernel`'s device time a step, in percent.

The least time is the bytes that the queries' shapes alone make a query
read and write, at the card's peak HBM bandwidth (port_bench/peaks.py):
each ray's origin and direction read once (24 bytes, float32), each hit's
t and face written once (8 bytes), and each vertex (12 bytes) and face
(three 4-byte indices) read once a query. Its operations, at most 30
FP32 operations for each (ray, triangle) pair that a culled search must
test, depend on the search and bound no time below the bytes' here. The
queries of a step: 3 on every lane of each ray view (two bounces and the
exit; the view's s^2 x resy x resx lanes, s the rig's `supersample`) and,
for each of the step's silhouette views, one of 2 rays for each of the
budget's edges. So the share reads the same work whatever implements the
query."""

from port_bench.capture import supersample
from port_bench.peaks import H100_HBM_BYTES_PER_S
from port_bench.tracing import kernel_ms


def step_bytes(config, mix, vertices, faces):
    rig = config["rig"]
    mesh = 12 * vertices + 12 * faces
    lanes = supersample(rig) ** 2 * rig["resy"] * rig["resx"]
    rays = (3 * mix["ray_views"] * [lanes]
            + mix["silh_views"] * [2 * config["silhouette_budget"]])
    return sum(32 * n + mesh for n in rays)


def read(trace):
    ms = kernel_ms(trace, ("closest_hit_kernel",))
    if ms is None:
        return None
    least_s = (step_bytes(trace.config, trace.mix, *trace.mesh)
               / H100_HBM_BYTES_PER_S)
    return 100.0 * least_s * 1e3 / ms
