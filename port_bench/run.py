"""Run one cell of the benchmark of agdiff_torch once.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. The cell names a
configuration (port_bench/configs/<name>.json, through BENCHMARK.json's
`file`) and a traffic mix (port_bench/workloads/<traffic>.json), whose
`kind` names the module that drives the program (port_bench/traffic/
<kind>.py). Set-up (imports, kernel builds, weights, warm-up) is timed
as `setup_s`; then the window runs for `--seconds`; then, with the
program's state freed, the correctness check. With --trace 0 the result
carries the cell's end-to-end metrics; with --trace 1 every call of the
window is traced (port_bench/trace.py) and the result carries the cell's
per-layer metrics, each read by port_bench/metrics/<metric name>.py.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with --trace 1), and last the
numbers the check compared beside their limits, which also end standard
error. Without a CUDA card, or with fewer than the cell asks for, it
prints no result and exits 2; if jax, jaxlib, flax or agdiff_tpu is
loaded once the window has closed, it exits 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "agdiff_tpu")


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell `name` of BENCHMARK.json with its configuration, traffic
    mix and the metrics it reports: {cell, config, traffic, end_to_end,
    per_layer}."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "port_bench", "workloads",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved
                                  else [])]
    return dict(cell=cell, config=config, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer)


def reader(metric: str, root: str = ROOT):
    """The `read` function of port_bench/metrics/<metric>.py."""
    path = os.path.join(root, "port_bench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def breakdown(calls) -> dict:
    ops, gaps = {}, {}
    for c in calls:
        for k, v in c["trace"]["ops"].items():
            ops[k] = ops.get(k, 0.0) + v
        for k, v in c["trace"]["gaps"].items():
            gaps[k] = gaps.get(k, 0.0) + v
    top = lambda d: [[k[:200], v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        raise SystemExit("--seed takes a whole number from 0")
    cache = os.path.join(ROOT, ".port_bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "extensions")
    spec = load_cell(args.workload)
    chips = spec["cell"]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: {chips} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" found; no result", file=sys.stderr)
        return 2
    out, lines = measure(spec, args.seed, args.seconds, args.trace,
                         torch.device("cuda"))
    if out is None:
        print("\n".join(lines), file=sys.stderr)
        return 3
    lines[0] += f", card {power_limit()}"
    print("\n".join(lines), file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def measure(spec: dict, seed: int, seconds: float, trace: int, device):
    """Set-up, the window and the check of one run of the cell `spec`
    (load_cell) on `device`: (the result's object, the lines for standard
    error), or (None, lines) when a forbidden module is loaded."""
    import torch

    cuda = device.type == "cuda"
    kind = importlib.import_module(
        f"port_bench.traffic.{spec['traffic']['kind']}")
    ctx = dict(spec, seed=seed, device=device)
    parts = dict(process_start=time.perf_counter() - T0)
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    parts["cuda_context"] = time.perf_counter() - T0 - parts["process_start"]
    traffic = kind.Traffic(ctx)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    tracer = None
    if trace:
        from port_bench.trace import CallTrace as tracer
    window = traffic.window(seconds, tracer)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        return None, [f"port_bench: {', '.join(found)} loaded in the run's "
                      f"process; no result"]
    traffic.release()
    t_check = time.perf_counter()
    checks = traffic.check()
    check_s = time.perf_counter() - t_check
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": spec["cell"]["chips"],
                   "memory_peak_bytes": int(peak)}
    metrics = {}
    if trace:
        calls = traffic.calls
        device_info["busy_s"] = sum(c["trace"]["busy_s"] for c in calls)
        device_info["window_s"] = sum(c["trace"]["window_s"] for c in calls)
        reading = dict(calls=calls, window=window, config=spec["config"],
                       traffic=spec["traffic"], setup_s=setup_s)
        for m in spec["per_layer"]:
            value = reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(traffic.end_to_end(window), setup_s=setup_s)
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    out = {"correct": correct, "attempted": window["attempted"],
           "failed": window["failed"], "metrics": metrics,
           "device": device_info}
    if trace:
        out["breakdown"] = breakdown(traffic.calls)
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    lines = [f"port_bench: {spec['cell']['name']} seed {seed}: "
             f"{window['calls']} calls, {window['window_s']:.3f} s window, "
             f"setup {setup_s:.3f} s, check {check_s:.3f} s, captures in "
             f"the window {window['captures']}",
             "setup parts (s): " + ", ".join(
                 f"{k} {v:.3f}" for k, v in dict(
                     parts, **getattr(traffic, "setup_parts", {})).items())]
    judged = getattr(traffic, "judged", None)
    if judged is not None:
        lines.append("check block ratios: " + " ".join(
            f"{d:.3g}" for d in judged["ratios"]))
    lines += [f"check {name}: {v!r} (limit {lim!r})"
              for name, v, lim in checks]
    return out, lines


if __name__ == "__main__":
    sys.exit(main())
