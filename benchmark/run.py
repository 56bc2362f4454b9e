"""Run one cell of the benchmark of ``f5tts_tpu_torch`` and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Builds the cell from its files (``core.py``),
makes its weights and inputs from ``--seed``, warms up the shapes its
traffic uses, measures for ``--seconds``, judges a sample of what the window
served against the plain reference, and prints as the last line of standard
output one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit, which also end standard
error. Exits non-zero, printing no result, without a CUDA card, or if JAX or
the JAX package was imported.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

T_START = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")
# the benchmark's modules are imported as ``benchmark.*``; its directory on the
# path would let them shadow standard modules (``trace``)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != os.path.join(ROOT, "benchmark")]


def _process_start() -> float:
    """Wall time this process was created (from ``/proc``), else the moment
    this module started running."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return T_START


def setup_env() -> None:
    """Fixed cache directories inside the checkout; no library loads JAX."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, os.path.join(CACHE, sub))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", control: str | None = None,
             bench_json: str | None = None) -> dict:
    """One run of a cell: the result object (without printing it)."""
    import torch

    from benchmark import core

    cell = core.load_cell(workload, bench_json)
    ctx = core.Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device=torch.device(device),
                       control=control)
    t0 = _process_start()
    out = core.driver(cell.traffic["kind"]).run(ctx)
    setup_s = ctx.counters["setup_done"] - t0 if device == "cuda" else ctx.counters["setup_done"] - T_START
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = core.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**out["end_to_end"], "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    checks = out["checks"]
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": core.device_block(ctx)}
    if trace and ctx.traced is not None:
        result["breakdown"] = {"device_ops": ctx.traced.top_ops(), "idle_gaps": [list(g) for g in ctx.traced.gaps]}
    if ctx.errors:
        result["errors"] = ctx.errors[:5]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    setup_env()
    import torch

    from benchmark import core

    chips = core.load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    foreign = core.foreign_modules()
    if foreign:
        print(f"modules of JAX or the JAX package were imported: {foreign}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
