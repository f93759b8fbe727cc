"""One run of one benchmark cell.

    python3 -m windbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json`` ``workloads``)
names a configuration (``windbench/configs/<config>.json``) and a traffic
mix (``windbench/traffic/<traffic>.json``, whose ``kind`` picks the driver
``windbench/drive_<kind>.py``); its check limits are in
``windbench/limits/<workload>.json`` and each per-layer metric is read by
``windbench/metrics/<metric>.py``. So a cell, a configuration, a mix or a
metric is added as files and entries, with no edit of a file here.

It prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics instead), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit.
The same numbers are the last lines of its standard error.

It exits with 3 and prints no result without a CUDA device (or with fewer
than the cell asks for), and with 4 if JAX, flax or the JAX package was
loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "gan_sr_wind_field_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Context:
    """What a driver needs: the cell's files, the run's arguments, the
    device, the recorder, and the profiler around the window."""

    def __init__(self, bench: dict, workload: str, seed: int, seconds: float,
                 trace: bool, device):
        from windbench import inputs
        from windbench.trace import Recorder

        self.root = str(ROOT)
        self.cell = next(w for w in bench["workloads"]
                         if w["name"] == workload)
        self.conf = inputs.load_json("configs", self.cell["config"])
        self.traffic = inputs.load_json("traffic", self.cell["traffic"])
        self.limits = inputs.load_json("limits", workload)
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = device
        self.t_start = T_START
        self.recorder = Recorder(traced=trace)
        self.log = log

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def start_profiler(self):
        if not self.trace:
            return None
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def stop_profiler(self, prof):
        if prof is None:
            return [], []
        from windbench.trace import profile_events

        self.sync()
        prof.stop()
        return profile_events(prof)


def _load_reader(name: str):
    path = ROOT / "windbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"windbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _for_cell(entries, workload):
    return [m for m in entries if workload in m.get("workloads", [workload])]


def judge(readings: dict, limits: dict):
    """Each number compared beside its limit, and whether all are within."""
    checks = {k: {"value": v, "limit": float(limits[k])}
              for k, v in readings.items()}
    return checks, all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values())


def run(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
        device, driver_kwargs=None) -> dict:
    """One run: the result object, its last key ``checks``."""
    import importlib

    from windbench.trace import Trace, breakdown, busy_seconds

    ctx = Context(bench, workload, seed, seconds, trace, device)
    kind = ctx.traffic["kind"]
    driver = importlib.import_module(f"windbench.drive_{kind}")
    out = driver.run(ctx, **(driver_kwargs or {}))
    checks, correct = judge(out["checks"], ctx.limits)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_name(device), "count": int(ctx.cell["chips"]),
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    if trace:
        tr = Trace(window_s=out["window_s"], spans=out["spans"],
                   counters=out["counters"], ops=out["ops"],
                   ranges=out["ranges"], cell=out["cell"])
        metrics = {}
        for m in _for_cell(bench["per_layer"], workload):
            v = _load_reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        for note in tr.notes:
            log(note)
        dev["busy_s"] = busy_seconds(tr)
        dev["window_s"] = out["window_s"]
        result["metrics"] = metrics
        result["device"] = dev
        result["breakdown"] = breakdown(tr)
    else:
        result["metrics"] = {
            m["name"]: {"value": out["metrics"][m["name"]],
                        "unit": units[m["name"]]}
            for m in _for_cell(bench["end_to_end"], workload)}
        result["device"] = dev
    result["checks"] = checks
    return result


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        log(f"the cell needs {cell['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " available")
        return 3
    result = run(bench, args.workload, args.seed, args.seconds,
                 bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
