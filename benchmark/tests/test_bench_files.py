"""Every cell and metric of ``BENCHMARK.json`` is found by name among the
benchmark's files, and a cell added as new files alone runs."""

import json
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import core  # noqa: E402
from benchmark.tests import tiny  # noqa: E402

SPEC = core.read_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_loads_from_its_files(cell):
    c = core.load_cell(cell)
    assert c.config["name"] == next(w["config"] for w in SPEC["workloads"] if w["name"] == cell)
    assert core.driver(c.traffic["kind"]).run
    assert c.end_to_end and any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert c.workload["limits"]["departures"] == 0
    assert c.workload["controls"] and set(c.workload["controls"]) <= {"reference:fp8", "program:int8"}


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_has_a_reader(metric):
    assert callable(core.metric_reader(metric).read)


def test_spec_follows_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.fullmatch(n) for n in names)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert all(0 < m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    assert all(m["moves"] in e2e for m in SPEC["per_layer"])
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_cell_added_as_new_files_alone_runs(tmp_path, monkeypatch):
    """A new traffic mix and a new cell, written as files beside the tiny copy,
    need no edit of any file the harness has."""
    bench_json, files = tiny.make_files(str(tmp_path))
    mix = core.read_json(os.path.join(files, "traffic", "offline-longform.json"))
    tiny._write(os.path.join(files, "traffic", "offline-short-voices.json"),
                {**mix, "pool_seed": 5, "voice_seconds": [3.0, 3.0]})
    tiny._write(os.path.join(files, "workloads", "f5tts-base.offline-short-voices.json"),
                core.read_json(os.path.join(files, "workloads", "f5tts-base.offline-longform.json")))
    spec = core.read_json(bench_json)
    spec["workloads"].append({"name": "f5tts-base.offline-short-voices", "config": "f5tts-base",
                              "traffic": "offline-short-voices", "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "f5tts-base.offline-longform" in m.get("workloads", []):
            m["workloads"].append("f5tts-base.offline-short-voices")
    tiny._write(bench_json, spec)
    cell = core.load_cell("f5tts-base.offline-short-voices", bench_json, files)
    assert cell.traffic["voice_seconds"] == [3.0, 3.0]
    from benchmark import run

    real = core.load_cell
    monkeypatch.setattr(core, "load_cell", lambda name, b=None, f=None: real(name, bench_json, files))
    res = run.run_cell("f5tts-base.offline-short-voices", 3, 0.2, False, device="cpu")
    assert res["correct"] and res["metrics"]["audio_s_per_s"]["value"] > 0
