"""One run of one cell of the port's benchmark (see README.md).

A cell names a configuration (configs/<name>.json), a traffic mix
(traffic/<name>.json) and, through BENCHMARK.json, the per-layer metrics
whose readers are metrics/<name>.py; the limits that decide `correct` are
limits/<cell>.json. Everything here is found by those names, so a later
cell, mix, configuration or metric is a file and a manifest entry.

The system under test is `drt_tpu_torch`: its padded mesh state, its train
step (`make_train_step`) and the CUDA graph `optimize` replays it in
(`GraphedTrainStep`). The set-up builds that one object, drives it from
the seed through its first `check_steps` steps, keeping each step's loss,
the optimizer's first-step state and the parameters after the last, and
hands it to the window. After the window the program is freed and the
configuration's plain reference (reference/<configuration>.py, step.py
where there is none) takes the same steps from the same inputs; `correct`
compares the two.
"""

from __future__ import annotations

import gc
import json
import math
import os
import sys
import time

import torch

from port_bench import capture, tracing
from port_bench import traffic as traffic_gen
from port_bench.meshio import load_mesh
from port_bench.reference.mesh import ref_mesh

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "drt_tpu")
PARTS = ("ray", "vh", "sm")     # the loss's terms, before their weights
REFERENCE = "step"             # the reference of a configuration with none
# What a reference module provides (reference/step.py's docstring).
INTERFACE = ("precision", "init_state", "step", "update", "first_grad",
             "grad_from_momentum")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def resolve(workload: str, root: str = ROOT):
    """(cell, configuration, mix, limits, {per-layer metric: unit}) of a
    workload of BENCHMARK.json."""
    man = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in man["configs"]}[cell["config"]]
    cfg = read_json(os.path.join(root, entry["file"]))
    here = os.path.join(root, "port_bench")
    mix = traffic_gen.load(cell["traffic"], os.path.join(here, "traffic"))
    limits = read_json(os.path.join(here, "limits", f"{workload}.json"))
    layer = {m["name"]: m["unit"] for m in man["per_layer"]
             if workload in m.get("workloads", [workload])}
    return cell, cfg, mix, limits, layer


def load_file(path: str, name: str):
    """The module of the Python file at path, entered in sys.modules as
    `name` (a dataclass of the module looks itself up there)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: str = ROOT):
    """The `read(trace)` of port_bench/metrics/<name>.py."""
    path = os.path.join(root, "port_bench", "metrics", f"{name}.py")
    return load_file(path, "port_bench_metric_"
                     + name.replace(".", "_").replace("-", "_")).read


def reference_of(cfg: dict, root: str = ROOT):
    """The plain reference of a configuration, loaded by path:
    port_bench/reference/<its name>.py of the checkout at root where that
    file exists, reference/step.py otherwise. It has to provide
    INTERFACE."""
    ref_dir = os.path.join(root, "port_bench", "reference")
    stem = cfg["name"]
    if not os.path.isfile(os.path.join(ref_dir, f"{stem}.py")):
        stem = REFERENCE
    mod = load_file(os.path.join(ref_dir, f"{stem}.py"),
                    "port_bench_reference_"
                    + stem.replace(".", "_").replace("-", "_"))
    missing = [k for k in INTERFACE if not callable(getattr(mod, k, None))]
    if missing:
        raise ValueError(f"reference/{stem}.py lacks {missing}")
    return mod


class Program:
    """The port's train step on one configuration, driven as `optimize`
    drives a pass: its mesh state, `make_train_step`'s step and the runner
    (`GraphedTrainStep` on the card) over the iterations' view rows."""

    def __init__(self, cfg, views, mesh_np, ray_rows, silh_rows, device,
                 runner=None):
        from drt_tpu_torch.data.views import ViewBatch
        from drt_tpu_torch.intersect.api import get_intersect_fn
        from drt_tpu_torch.mesh.state import build_mesh_state
        from drt_tpu_torch.optimize.loop import (GraphedTrainStep,
                                                 make_train_step)
        from drt_tpu_torch.optimize.losses import LossWeights
        rig = cfg["rig"]
        self.mesh = build_mesh_state(*mesh_np, dtype=dtype_of(cfg),
                                     device=device)
        weights = LossWeights(ray_w=cfg["ray_w"], vh_w=cfg["vh_w"],
                              sm_w=cfg["sm_w"], ior=cfg["ior"],
                              ext_ior=cfg["ext_ior"])
        init, step, _ = make_train_step(
            get_intersect_fn("auto"), weights, rig["resy"], rig["resx"],
            cfg["silhouette_budget"], momentum=cfg["momentum"],
            optimizer=cfg["optimizer"], precond=cfg["precond"],
            precond_lambda=cfg["precond_lambda"], cg_iters=cfg["cg_iters"],
            grad_clamp=cfg["grad_clamp"])
        state = init(self.mesh)
        runner = runner or GraphedTrainStep
        self.run = runner(
            step, state, cfg["lr"], self.mesh, ViewBatch(*views),
            torch.tensor(ray_rows, dtype=torch.int64, device=device),
            torch.tensor(silh_rows, dtype=torch.int64, device=device))
        self.fresh = {k: v.clone() for k, v in self.run.state.items()}
        self.rows = len(ray_rows)
        self.calls = 0

    def __call__(self):
        self.calls += 1
        return self.run()

    def reset(self):
        """Set the step's state back to the pass's fresh state."""
        for k, v in self.fresh.items():
            self.run.state[k].copy_(v)

    def first_steps(self, n: int, optimizer: str, ref) -> dict:
        """Run the first n steps: each step's loss and its parts, the
        first gradient as the optimizer got it (from its state after one
        step, by the reference module ref's `first_grad`), the parameters'
        change after the n, each step's parameters and momentum, and the
        pass's fresh parameters and momentum, over the mesh's own
        vertices."""
        nv = self.mesh.num_vertices
        losses, parts, states = [], [], []
        for _ in range(n):
            loss, aux = self()
            losses.append(float(loss))
            parts.append({**{p: float(aux[p]) for p in PARTS},
                          "lanes": float(aux["valid_rays"])})
            states.append({"params": self.run.state["params"][:nv].clone(),
                           "m": self.run.state["m"][:nv].clone(),
                           "v": float(self.run.state["v"])})
        delta = (self.run.state["params"] - self.fresh["params"])[:nv]
        return {"losses": losses, "parts": parts, "states": states,
                "g1": ref.first_grad(states[0]["m"], optimizer),
                "delta": delta.clone(),
                "fresh": {k: self.fresh[k][:nv].clone()
                          for k in ("params", "m")}}

    def close(self):
        self.run.close()
        self.run = self.fresh = self.mesh = None


def dtype_of(cfg) -> torch.dtype:
    """The configuration's stated precision as a torch dtype."""
    dtype = getattr(torch, cfg["dtype"], None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"configuration {cfg['name']!r}: dtype "
                         f"{cfg['dtype']!r} is not a floating type")
    return dtype


CONTROLS = {"tf32": {"tf32": True}, "ray_bf16": {"ray_dtype": torch.bfloat16}}
FAULTS = ("half", "frozen")
# Of the vertices, the share whose rows `rows_gap` reads below its value
# (the rest, at most a tenth, may differ as far as they like).
ROWS_QUANTILE = 0.9


def reference_steps(cfg, ref, views, mesh_np, ray_rows, silh_rows, device,
                    control=None, fault=None) -> dict:
    """The first len(ray_rows) steps of the configuration's reference
    module ref (`reference_of`), as `first_steps` reads the program's, the
    change taken from its own `init_state`'s parameters. `control` (a key
    of CONTROLS) runs it one precision lower; `fault` (one of FAULTS)
    plants that fault (reference/step.py). A row of one ray view passes
    the reference its int, a row of more the whole list."""
    kw = CONTROLS[control] if control else {}
    with ref.precision(kw.get("tf32", False)):
        mesh = ref_mesh(*mesh_np, device)
        if mesh.vertices.dtype != dtype_of(cfg):
            raise ValueError(f"the reference runs {mesh.vertices.dtype}, "
                             f"the configuration states {cfg['dtype']}")
        state = ref.init_state(mesh)
        fresh = {k: state[k].clone() for k in ("params", "m")}
        losses, parts, states = [], [], []
        for r, s in zip(ray_rows, silh_rows):
            state, loss, part = ref.step(state, cfg["lr"], mesh, views,
                                         r[0] if len(r) == 1 else list(r),
                                         list(s), cfg, fault=fault,
                                         ray_dtype=kw.get("ray_dtype"))
            losses.append(loss)
            parts.append(part)
            states.append({"params": state["params"].clone(),
                           "m": state["m"].clone(),
                           "v": float(state.get("v", 0.0))})
    return {"losses": losses, "parts": parts, "states": states,
            "g1": ref.first_grad(states[0]["m"], cfg["optimizer"]),
            "delta": state["params"] - fresh["params"], "fresh": fresh}


def rows_gap(a, b, own_scale=False, q=ROWS_QUANTILE) -> float:
    """The q-quantile over vertices of the distance between the rows of a
    and b [V,3], over the median length of b's rows; with own_scale each
    side is first divided by the median length of its own rows (a side
    whose median row is nought stays nought). The few vertices that the
    lanes at a discontinuity move lie above the quantile, so they do not
    set it; a sign, rows on the wrong vertices or a scale (unless
    own_scale) on more than 1 - q of the vertices do."""
    a, b = a.double(), b.double()
    ma, mb = a.norm(dim=1).median(), b.norm(dim=1).median()
    if own_scale:
        a = a / ma if ma > 0 else a
        b, mb = (b / mb, mb / mb) if mb > 0 else (b, mb)
    if not mb > 0:
        return math.inf
    return float(torch.quantile((a - b).norm(dim=1), q) / mb)


def rule_gap(states, cfg, ref, fresh) -> float:
    """The optimizer's stage followed from the run's own state, from its
    fresh parameters and momentum (`fresh`): each step's gradient is read
    back from its momentum before and after (the reference module ref's
    `grad_from_momentum`), the reference's `update` is applied to the
    state before the step, and the worst step's gap between the
    parameters' change the run made and the one the update gives, over
    the norm of the latter. It sees the learning rate, the bias
    correction, the second moment and parameters left unwritten, which the
    gradient's numbers do not; the gradients it starts from are the run's,
    which the other numbers hold to the reference's."""
    opt = cfg["optimizer"]
    prev = {k: fresh[k].double() for k in ("params", "m")}
    prev.update(v=0.0, count=0)
    worst = 0.0
    for st in states:
        p, m = st["params"].double(), st["m"].double()
        g = ref.grad_from_momentum(m, prev["m"], opt, cfg["momentum"])
        want = ref.update(prev, g, cfg["lr"], cfg)
        made, due = p - prev["params"], want["params"] - prev["params"]
        nd = float(torch.linalg.norm(due))
        gap = float(torch.linalg.norm(made - due))
        worst = max(worst, gap / nd if nd else gap)
        prev = dict(want, params=p, m=m)
    return worst


def gaps(prog: dict, want: dict, cfg, ref) -> dict:
    """The numbers compared (PERF.md says which decide `correct`, and
    why): the worst step's relative gap of the loss, of each of its parts
    and of the ray view's counted lanes (those that refract twice and
    escape); the gaps between the norms, and between the medians of the
    magnitudes, of the first gradient and of the parameters' change, each
    against the reference's (one parameter leaf: the vertex
    displacement); their `rows_gap`s, and the change's median one at
    each side's own scale (`update_dir_gap`); and the run's
    `rule_gap` (by the reference module ref)."""
    def rel(a, b):
        return abs(a - b) / abs(b) if b else abs(a - b)

    out = {"loss_gap": max(rel(a, b) for a, b in zip(prog["losses"],
                                                     want["losses"]))}
    for p in (*PARTS, "lanes"):
        out[f"{p}_gap"] = max(rel(a[p], b[p]) for a, b in
                              zip(prog["parts"], want["parts"]))
    for name, key in (("grad", "g1"), ("update", "delta")):
        a, b = prog[key].double(), want[key].double()
        out[f"{name}_gap"] = rel(float(torch.linalg.norm(a)),
                                 float(torch.linalg.norm(b)))
        out[f"{name}_median_gap"] = rel(float(a.abs().median()),
                                        float(b.abs().median()))
        out[f"{name}_rows_gap"] = rows_gap(a, b)
    out["update_dir_gap"] = rows_gap(prog["delta"], want["delta"], True, 0.5)
    out["update_rule_gap"] = rule_gap(prog["states"], cfg, ref,
                                      prog["fresh"])
    return out


def judge(found: dict, limits: dict):
    """(correct, checks): every number that has a limit at or under it."""
    checks = {k: {"value": found[k], "limit": limits[k]}
              for k in found if k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_window(prog: Program, mix: dict, seconds: float, device):
    """Replays in blocks of `block_steps` (the state set back to the
    pass's fresh state before each), the loss read every `log_every`
    steps; the window closes at the first read past `seconds`. Returns
    (steps, seconds, reads that were not finite)."""
    block, every = mix["block_steps"], mix["log_every"]
    steps = bad = 0
    reads = []
    _sync(device)
    t0 = time.perf_counter()
    while True:
        if steps % block == 0:
            prog.reset()
        loss, _aux = prog()
        steps += 1
        if steps % every == 0:
            bad += not math.isfinite(float(loss))
            reads.append(time.perf_counter() - t0)
            if reads[-1] >= seconds or prog.calls + block > prog.rows:
                break
    _sync(device)
    return steps, time.perf_counter() - t0, bad, reads


def traced_block(prog: Program, mix: dict, device):
    """One block of `block_steps` replays under torch.profiler: (steps,
    window seconds, bad reads, device events, host events)."""
    from torch.profiler import ProfilerActivity, profile
    block, every = mix["block_steps"], mix["log_every"]
    bad = 0
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prog.reset()
        for k in range(block):
            loss, _aux = prog()
            if (k + 1) % every == 0:
                bad += not math.isfinite(float(loss))
        _sync(device)
        window = time.perf_counter() - t0
    device_ev, host_ev = tracing.collect(prof)
    return block, window, bad, device_ev, host_ev


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, root: str = ROOT, device=None, runner=None,
             log=print) -> dict:
    """One run of a cell: the result's line (see README.md) and its
    checks. `device` and `runner` let a test drive it without the card."""
    marks = {"entry": time.time()}
    cell, cfg, mix, limits, layer = resolve(workload, root)
    ref = reference_of(cfg, root)
    device = torch.device(device or "cuda")
    rig = cfg["rig"]
    gt = load_mesh(root, cfg["ground_truth"])
    init = load_mesh(root, cfg["init_mesh"])
    views = capture.load(*gt, cfg, device,
                         os.path.join(root, "port_bench", ".cache"))
    _sync(device)
    marks["capture"] = time.time()
    n_check = mix["check_steps"]
    rows = (n_check + mix["block_steps"]
            * (math.ceil(seconds * mix["max_steps_per_s"]
                         / mix["block_steps"]) + 1))
    ray_rows, silh_rows = traffic_gen.view_rows(mix, rig["num_views"], seed,
                                                rows)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prog = Program(cfg, views, init, ray_rows, silh_rows, device, runner)
    _sync(device)
    marks["program"] = time.time()
    first = prog.first_steps(n_check, cfg["optimizer"], ref)
    # The set-up's garbage is collected here, not by a collection that
    # would fall inside the window.
    gc.collect()
    _sync(device)
    marks["first_steps"] = time.time()
    setup_s = marks["first_steps"] - t_start
    phases, prev = {}, t_start
    for k, t in marks.items():
        phases[k] = t - prev
        prev = t
    log(f"setup {json.dumps({**phases, **prog.run.setup})}", file=sys.stderr)
    out = {"attempted": 0, "failed": 0, "metrics": {}}
    if trace:
        steps, window, bad, dev_ev, host_ev = traced_block(prog, mix,
                                                           device)
        busy = tracing.busy_us(dev_ev) * 1e-6
        import drt_tpu_torch
        tr = tracing.Trace(dev_ev, host_ev, steps, window, busy, cfg, mix,
                           (len(init[0]), len(init[1])),
                           tracing.port_kernels(os.path.dirname(
                               drt_tpu_torch.__file__)))
        for name, unit in layer.items():
            value = metric_reader(name, root)(tr)
            if value is not None:
                out["metrics"][name] = {"value": value, "unit": unit}
        t0 = min(s for _, s, _ in host_ev) if host_ev else 0.0
        t1 = max(e for _, _, e in dev_ev + host_ev) if dev_ev else t0
        out["breakdown"] = tracing.breakdown(dev_ev, host_ev, t0, t1)
        extra = {"busy_s": busy, "window_s": window}
    else:
        steps, window, bad, reads = step_window(prog, mix, seconds, device)
        every = mix["log_every"]
        log("window ms a step, by reads: " + " ".join(
            f"{(b - a) * 1e3 / every:.3f}"
            for a, b in zip([0.0] + reads, reads)), file=sys.stderr)
        out["metrics"]["step_ms"] = {"value": window * 1e3 / steps,
                                     "unit": "ms"}
        out["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
        extra = {}
    out["attempted"], out["failed"] = steps, bad
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    prog.close()
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_steps(cfg, ref, views, init, ray_rows[:n_check],
                           silh_rows[:n_check], device)
    found = gaps(first, want, cfg, ref)
    log(f"gaps {json.dumps(found)}", file=sys.stderr)
    correct, checks = judge(found, limits)
    out["correct"] = correct and bad == 0
    out["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": 1, "memory_peak_bytes": int(peak), **extra}
    out["checks"] = checks
    return out

