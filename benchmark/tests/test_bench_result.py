"""A run's last line holds exactly the contract's keys, and a run without a
card prints no result and fails."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.tests import tiny  # noqa: E402

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload,trace", [("f5tts-base.offline-longform", False),
                                            ("f5tts-base.offline-longform", True),
                                            ("e2tts-base.offline-longform", False),
                                            ("e2tts-base.offline-longform", True)])
def test_result_line_keys(tmp_path, monkeypatch, workload, trace):
    res = tiny.run_tiny(monkeypatch, tmp_path, workload, seconds=0.2, trace=trace)
    keys = list(res)
    assert keys[: len(REQUIRED)] == REQUIRED and keys[-1] == "checks"
    assert set(keys) <= set(REQUIRED) | {"breakdown", "checks"} and ("breakdown" in keys) == trace
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    from benchmark import core

    spec = core.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    want = [m["name"] for m in spec["per_layer" if trace else "end_to_end"] if workload in m.get("workloads", [workload])]
    if trace:  # the device's readers find nothing to read on the CPU
        assert set(res["metrics"]) <= set(want) and res["metrics"]
    else:
        assert set(res["metrics"]) == set(want)
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from benchmark import run

    rc = run.main(["--workload", "f5tts-base.offline-longform", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_jax_in_the_process_fails_the_run(monkeypatch):
    from benchmark import core

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert core.foreign_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib.xla_client")
    monkeypatch.setitem(sys.modules, "f5tts_tpu_torch_extra", object())
    assert core.foreign_modules() == []
