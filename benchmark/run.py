"""Run one cell of the benchmark once, on the machine it is started on.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration and traffic mix; everything that belongs to one of them
sits in files of its own, found by name:

* ``benchmark/configs/<config>.json``: the model's configuration as run;
* ``benchmark/traffic/<mix>.json``: the mix's parameters, and the driver
  (``benchmark/drivers/<driver>.py``) that generates it and runs the
  program;
* ``benchmark/limits/<workload>.json``: the limit of each number that the
  cell's comparison with the reference reads;
* ``benchmark/metrics/<metric>.py``: the reader of one per-layer metric,
  ``read(record)``, which returns a number or None (nothing to read).

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones (the driver then profiles a segment of
the same loop after the window). The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` and, traced, ``breakdown``; ``compared`` comes last, each number
of the comparison with its limit, which also end standard error. Without
a CUDA device, or with fewer than the cell asks for, it exits with 2 and
prints no result; it exits with 3 if ``jax``, ``jaxlib``, ``flax``,
``optax``, ``orbax`` or the JAX package is loaded when the window has
closed.
The program's host work runs on one CPU thread (``torch.set_num_threads``):
one process with few threads is the steadier load.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel and build caches at fixed paths inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, "build", "bench_cache", _sub)

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "caesar_mrcnn_tpu")


def process_start() -> float:
    """The process's start on the ``time.time`` clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


START = process_start()


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "power limit unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "power limit unknown"


class Context:
    """What a driver gets: the run's arguments, the cell's files, the
    device and its counters, the clock since the process started, and a
    log to standard error."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, config: Dict, traffic: Dict,
                 device, tmp_dir: str, make_detector: Optional[Callable] = None, detail: Optional[Dict] = None):
        self.workload, self.seed, self.seconds, self.trace = workload, seed, seconds, trace
        self.config, self.traffic, self.device, self.tmp_dir = config, traffic, device, tmp_dir
        self.make_detector = make_detector
        self.detail = detail  # a dict that a driver fills with its comparison's distributions
        self.cuda = getattr(device, "type", str(device)) == "cuda"

    def elapsed(self) -> float:
        return time.time() - START

    def log(self, msg: str) -> None:
        print(f"[{self.workload}] {msg}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peak_bytes(self) -> int:
        if not self.cuda:
            return 0
        import torch

        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated())

    def empty_cache(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.empty_cache()


def _metric_reader(name: str):
    """``read`` of ``benchmark/metrics/<name>.py`` (a file name with dots,
    so loaded by path)."""
    path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def find_cell(manifest: Dict, workload: str) -> Optional[Dict]:
    return next((w for w in manifest["workloads"] if w["name"] == workload), None)


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda", config: Optional[Dict] = None,
             traffic: Optional[Dict] = None, make_detector: Optional[Callable] = None,
             detail: Optional[Dict] = None) -> Dict:
    """One run of ``workload``; returns the result object. ``config`` and
    ``traffic`` replace the cell's files (tests run a cell at a small size
    on the CPU); ``make_detector(model_cfg, state_dict, device)`` replaces
    the driver's way of building the program."""
    import torch

    manifest = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = find_cell(manifest, workload)
    if cell is None:
        raise SystemExit(f"unknown workload {workload!r}")
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = config or load_json(os.path.join(ROOT, entry["file"]))
    traffic = traffic or load_json(os.path.join(ROOT, "benchmark", "traffic", f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(ROOT, "benchmark", "limits", f"{workload}.json"))
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    dev = torch.device(device)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(workload, seed, seconds, trace, config, traffic, dev, tmp, make_detector, detail)
        out = driver.run(ctx)
        found = forbidden_modules()
        if found:
            print(f"forbidden modules loaded in the benchmark's process: {', '.join(found)}", file=sys.stderr)
            raise SystemExit(3)
        record = out["record"]
        if trace:
            metrics = {}
            for m in manifest["per_layer"]:
                if applies(m, workload):
                    value = _metric_reader(m["name"])(record)
                    if value is not None:
                        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
                       for m in manifest["end_to_end"] if applies(m, workload)}
    compared = {k: {"value": v, "limit": limits.get(k)} for k, v in out["compared"].items()}
    correct = (bool(compared) and out["failed"] == 0
               and all(c["limit"] is not None and c["value"] <= c["limit"] for c in compared.values()))
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                         "count": cell["chips"], "memory_peak_bytes": out["peak_bytes"]}}
    summary = record.get("trace")
    if trace and summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    cell = find_cell(load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(f"card: {card()}", file=sys.stderr, flush=True)
    torch.set_num_threads(1)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    for name, c in result["compared"].items():
        print(f"compared: {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
