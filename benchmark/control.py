"""The control of a cell's comparison: the cell run with a lower-precision
stand-in for the program, which ``correct`` has to refuse.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 10 [--program]

The stand-ins are the cell's ``controls`` (``benchmark/workloads/<cell>.json``),
or ``--control``: ``program:int8`` serves with the program's own W8A8 int8
path (F5-TTS; the UNetT has none); ``reference:fp8`` puts the reference,
holding every tensor in float8 e4m3, in the program's place. With ``--program`` each seed is also run as the
benchmark runs it, in the same process, so that the program's readings and
the control's come from one set-up of the card. Prints one JSON line per run
(``seed``, ``control``, ``correct``, ``checks``). The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [_ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.join(_ROOT, "benchmark")]

from benchmark import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--program", action="store_true", help="also run each seed without the control")
    p.add_argument("--control", default=None, help="another stand-in than the cell's")
    args = p.parse_args(argv)
    run.setup_env()
    from benchmark import core

    controls = [args.control] if args.control else core.load_cell(args.workload).workload["controls"]
    for seed in (int(s) for s in args.seeds.split(",")):
        for which in ([None] if args.program else []) + controls:
            res = run.run_cell(args.workload, seed, args.seconds, False, control=which)
            print(json.dumps({"seed": seed, "control": which, "correct": res["correct"], "checks": res["checks"],
                              "metrics": res["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
