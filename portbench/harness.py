"""One run of one cell, driven by data.

``BENCHMARK.json`` names the cell's configuration and traffic; the harness
reads the configuration's file, ``traffic/<traffic>.json`` (which names its
driver, ``drivers/<driver>.py``, and holds its parameters) and the cell's
limits, ``limits/<cell>.json``.  The driver sets the program up, runs the
window, and judges what the timed path produced; each metric is read by
``metrics/<metric>.py`` from the run.  A cell, a traffic mix, a driver or a
metric is added by adding its files and its entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench.lib import seeds
from portbench.lib.trace import DeviceTrace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# no run may load these top-level modules: JAX, and the JAX package and its reference
FOREIGN = frozenset({"jax", "jaxlib", "flax", "gymgo_tpu", "gym_go"})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` with its configuration, traffic and
    limits read from their files."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(name, entry["chips"], load_json(root / config["file"]),
                load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                load_json(HERE / "limits" / f"{name}.json"))


def metric_entries(bench: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of the cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones.  A metric without ``workloads`` belongs to
    every cell (a per-layer one, to every cell that reports its ``moves``)."""
    own = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return own
    names = {m["name"] for m in own}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in names)]


def reader(name: str):
    """``metrics/<name>.py``'s ``read(run) -> float | None``; a metric split by
    the end-to-end metric it moves (``device_idle_pct.env``) falls back to the
    reader of the name before its first dot (``metrics/device_idle_pct.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


@dataclasses.dataclass
class Context:
    """What a driver gets: the run's settings and the cell's data."""

    device: torch.device
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    t_start: float
    setup_s: float | None = None
    card_state: str | None = None

    def note(self, what: str) -> None:
        """Log a stage of set-up with the seconds since the process started."""
        print(f"[setup] {what} at {time.perf_counter() - self.t_start:.3f} s", file=sys.stderr, flush=True)

    def settle(self, unit) -> None:
        """The last stage of set-up: ``unit()`` (the window's own unit of
        work) again and again for the traffic's ``settle_s`` seconds.  A
        process's replayed CUDA graphs start with each node about 0.35 us
        slower on the card, whatever the work, and drop to the faster pace
        once, most often within 20 s; this keeps that warm-up out of the
        window."""
        t0, units = time.perf_counter(), 0
        while time.perf_counter() - t0 < self.traffic.get("settle_s", 0):
            unit()
            units += 1
        self.note(f"settled over {units} units")

    def setup_done(self) -> None:
        """Call right before the first timed step."""
        self.setup_s = time.perf_counter() - self.t_start
        self.note("done")

    def rng(self, purpose: str) -> np.random.Generator:
        return np.random.default_rng(seeds.derive(self.seed, purpose))

    def generator(self, purpose: str) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seeds.derive(self.seed, purpose))

    def spread(self, what: str, seconds: list) -> None:
        """Log the spread of the window's units of work (host clock)."""
        q = np.percentile(seconds, [0, 5, 50, 95, 100]) * 1e3 if seconds else []
        print(f"[window] {len(seconds)} {what}, ms min/p5/p50/p95/max " + " ".join(f"{x:.3f}" for x in q),
              file=sys.stderr, flush=True)

    def window_closed(self) -> int:
        """Call when the window (and the traced section) has closed: reads the
        card's state beside it, and returns the memory peak."""
        if self.device.type != "cuda":
            return 0
        query = "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
        out = subprocess.run(["nvidia-smi", "-i", str(self.device.index or 0), query, "--format=csv,noheader"],
                             capture_output=True, text=True)
        self.card_state = out.stdout.strip() if out.returncode == 0 else "nvidia-smi failed"
        return torch.cuda.max_memory_allocated(self.device)


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: host-clock readings of the window, the work
    attempted and failed, the memory peak read when the window closed, the
    judge's readings, and the traced section's trace."""

    host: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    readings: dict
    trace: DeviceTrace | None = None


@dataclasses.dataclass
class Run:
    """What a metric's reader gets."""

    cell: Cell
    setup_s: float
    host: dict
    trace: DeviceTrace | None


def run_cell(bench: dict, c: Cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """Run the cell once.  Returns ``(result, checks, readings)``: the result
    line's object (``checks`` last), ``[(name, reading, limit)]`` and every
    reading of the judge, those without a limit too."""
    device = torch.device(device)
    ctx = Context(device, seed, seconds, trace, c.config, c.traffic, t_start)
    ctx.note("harness loaded")
    out = driver(c.traffic["driver"]).run(ctx)
    run = Run(c, ctx.setup_s, out.host, out.trace)
    metrics = {}
    for m in metric_entries(bench, c.name, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = [(name, float(out.readings.get(name, math.inf)), float(limit)) for name, limit in c.limits.items()]
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": c.chips, "memory_peak_bytes": out.memory_peak_bytes, "state": ctx.card_state}
    result = {"correct": all(math.isfinite(v) and v <= lim for _, v, lim in checks),
              "attempted": out.attempted, "failed": out.failed, "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": out.trace.top_ops(), "idle_gaps": out.trace.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result, checks, out.readings


def foreign_modules() -> list:
    """The loaded modules whose top-level name is one no run may load."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FOREIGN})
