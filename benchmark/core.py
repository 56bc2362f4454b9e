"""What every cell shares: finding a cell's files by name, the run's context
handed to the traffic drivers and metric readers, host spans and counters,
and the result line.

A cell named in ``BENCHMARK.json`` is found as files:

- ``benchmark/configs/<config>.json``: the model configuration;
- ``benchmark/traffic/<traffic>.json``: the traffic mix, whose ``kind`` names
  its driver ``benchmark/traffic/<kind>.py``;
- ``benchmark/workloads/<cell>.json``: the cell's correctness limits and the
  size of its traced part;
- ``benchmark/metrics/<metric>.py``: one reader per per-layer metric, each
  with ``read(ctx) -> float | None``.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import statistics
import time
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
PEAK_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16 tensor-core operations per second
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes per second
JAX_NAMES = ("jax", "jaxlib", "flax", "f5tts_tpu")


def read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list[dict]  # this cell's end-to-end metrics from BENCHMARK.json
    per_layer: list[dict]  # this cell's per-layer metrics from BENCHMARK.json
    chips: int = 1
    files: str = BENCH_DIR  # where its configs, traffic and workloads directories are

    def path(self, kind: str, name: str) -> str:
        return os.path.join(self.files, kind, name)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_json: str | None = None, files: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``bench_json`` (the checkout's ``BENCHMARK.json``),
    its files read from the directory ``files`` (``benchmark/``)."""
    spec = read_json(bench_json or os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = read_json(os.path.join(files, "configs", f"{entry['config']}.json"))
    traffic = read_json(os.path.join(files, "traffic", f"{entry['traffic']}.json"))
    workload = read_json(os.path.join(files, "workloads", f"{name}.json"))
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _applies(m, name) and m["moves"] in e2e_names]
    return Cell(name, config, traffic, workload, e2e, layer, entry["chips"], files)


def driver(kind: str):
    return importlib.import_module(f"benchmark.traffic.{kind}")


def metric_reader(name: str):
    return importlib.import_module(f"benchmark.metrics.{name.replace('.', '_')}")


class Spans:
    """Host-clock spans by name, recorded by the benchmark's own code around its
    calls into the program: durations in seconds, and ``(name, start, end)``
    in wall-clock ns (what the device trace's gaps are named by)."""

    def __init__(self):
        self.times: dict[str, list[float]] = {}
        self.intervals: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0, w0 = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.times.setdefault(name, []).append(time.perf_counter() - t0)
            self.intervals.append((name, w0, time.time_ns()))


@dataclass
class Context:
    """What a run gathers for the metric readers."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object = None
    window_s: float = 0.0
    spans: Spans = field(default_factory=Spans)
    counters: dict = field(default_factory=dict)
    traced: object = None  # benchmark.trace.Trace of the traced part
    traced_counters: dict = field(default_factory=dict)
    control: str | None = None  # a lower-precision stand-in for the program (benchmark/control.py)
    errors: list = field(default_factory=list)

    def family(self):
        from benchmark.backbones import family

        return family(self.cell.config["family"])

    def vocoder(self):
        from benchmark.backbones import family

        return family(self.cell.config["vocoder"]["family"])


def quantile(values, q: float) -> float:
    """The ``q``-quantile by Python's ``statistics.quantiles`` (exclusive method)."""
    values = sorted(values)
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100)[round(q * 100) - 1]


def foreign_modules() -> list[str]:
    import sys

    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in JAX_NAMES})


def device_block(ctx: Context) -> dict:
    import subprocess

    import torch

    if ctx.device.type != "cuda":  # the CPU tests' runs
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": ctx.cell.chips,
           "memory_peak_bytes": int(ctx.counters["memory_peak_bytes"])}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        out["power_limit"] = q.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = "not read"
    if ctx.traced is not None:
        out["busy_s"] = ctx.traced.busy_s
        out["window_s"] = ctx.traced.window_s
    return out
