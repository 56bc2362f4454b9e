"""The comparison refuses a broken timed path. Each fault a serving cell can
have is planted under a tiny CPU run (the harness's look for a card skipped),
and ``correct`` must come out false; the same run without a fault is correct.
Every row of the window is compared, so that a fault in any row shows. The
cells run on one chip, so there is no exchange between chips to leave out.
Each cell's control, and an engine that holds its weights in another dtype
than the configuration states, are refused too."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.tests import tiny  # noqa: E402

CELLS = ["f5tts-base.offline-longform", "e2tts-base.offline-longform"]
ALL = {"sample_rows": 1000}


def _state_unchanged(monkeypatch):
    """Every ODE step returns the state it was given."""
    import f5tts_tpu_torch.sampling.euler as eu

    monkeypatch.setattr(eu, "_rk_step", lambda method, evals, y, t0, t1: (y, y, y))


def _half_batch(monkeypatch):
    """The second half of every solve's rows is left out: zeros (a batch of
    one keeps none)."""
    import f5tts_tpu_torch.engine.engine as en

    real = en.TTSEngine.bucket_program

    def halved(self, cond, *a, **kw):
        out = real(self, cond, *a, **kw)
        keep = cond.shape[0] // 2
        return tuple(torch.cat([t[:keep], torch.zeros_like(t[keep:])]) for t in out)

    monkeypatch.setattr(en.TTSEngine, "bucket_program", halved)


def _answer_altered(monkeypatch):
    """The vocoder's wave is altered where it is produced."""
    import f5tts_tpu_torch.engine.engine as en

    real = en.vocos_decode
    monkeypatch.setattr(en, "vocos_decode", lambda *a, **kw: real(*a, **kw) * 1.5)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch, "answer_altered": _answer_altered}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_fault_makes_the_run_incorrect(tmp_path, monkeypatch, cell, fault):
    if fault is not None:
        FAULTS[fault](monkeypatch)
    res = tiny.run_tiny(monkeypatch, tmp_path, cell, seconds=0.2, workload_overrides=ALL)
    assert res["correct"] is (fault is None), res["checks"]
    if fault is not None:
        assert any(not np.isfinite(c["value"]) or c["value"] > c["limit"] for c in res["checks"].values())


def _bf16_engine(monkeypatch):
    """The engine serves in another dtype than the configuration states."""
    import f5tts_tpu_torch.engine.engine as en

    real = en.TTSEngine.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self.dit_params = {k: _cast(v) for k, v in self.dit_params.items()}

    monkeypatch.setattr(en.TTSEngine, "__init__", init)


def _cast(tree):
    if isinstance(tree, dict):
        return {k: _cast(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16) if isinstance(tree, torch.Tensor) and tree.is_floating_point() else tree


CONTROLS = [(c, k) for c in CELLS
            for k in tiny.read_json(os.path.join(ROOT, "benchmark", "workloads", f"{c}.json"))["controls"]]


@pytest.mark.parametrize("cell,control", CONTROLS)
def test_control_is_refused(tmp_path, monkeypatch, cell, control):
    """Each of the cell's controls (F5: the program's own W8A8 int8 path and
    the reference held in fp8; E2, which has no int8 path: the reference in
    fp8) comes out not correct."""
    res = tiny.run_tiny(monkeypatch, tmp_path, cell, seconds=0.2, control=control)
    assert res["correct"] is False, res["checks"]
    if control == "program:int8":
        assert res["checks"]["departures"]["value"] > 0


def test_weights_in_another_dtype_are_a_departure(tmp_path, monkeypatch):
    _bf16_engine(monkeypatch)
    res = tiny.run_tiny(monkeypatch, tmp_path, "f5tts-base.offline-longform", seconds=0.2)
    assert res["correct"] is False and res["checks"]["departures"]["value"] > 0, res["checks"]
