"""The Indic Parler-TTS cell on the CPU: it loads from its files and runs to
``correct`` through ``run.run_cell`` on a tiny copy (float32, the kernels'
plain versions); its judgement refuses a broken program and the reference held
in fp8; its readers read the program's spans and counters; and the FLOP and
byte counts of ``backbones/parler.py`` against hand counts."""

import copy
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import core  # noqa: E402
from benchmark.backbones import parler as BP  # noqa: E402
from benchmark.tests.tiny import _write  # noqa: E402

CELL = "indic-parler-tts.offline-sentences"
TINY_MODEL = {
    "t5": {"vocab": 256, "d_model": 32, "d_kv": 8, "d_ff": 48, "heads": 4, "layers": 2, "rel_buckets": 8,
           "rel_max_dist": 20},
    "decoder": {"vocab": 40, "codebooks": 3, "hidden": 32, "layers": 2, "heads": 4, "ffn": 64, "cross_dim": 32,
                "prompt_vocab": 256},
    "dac": {"num_codebooks": 3, "codebook_size": 32, "codebook_dim": 4, "latent_dim": 16, "decoder_dim": 16,
            "rates": [2, 2], "sampling_rate": 44100},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the test workers share the host's cores
    yield
    torch.set_num_threads(n)


def tiny_files(tmp) -> tuple[str, str]:
    """``(BENCHMARK.json, files)``: the cell's own files at a tiny size."""
    spec = core.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    files = os.path.join(tmp, "bench")
    for sub in ("configs", "traffic", "workloads"):
        os.makedirs(os.path.join(files, sub), exist_ok=True)
    cell = core.load_cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["model"] = TINY_MODEL
    cfg["tokenizer"]["end_id"] = 256
    cfg["serving"]["engine"].update(max_frames=6, compute_dtype="float32", batch_buckets=[1, 2, 4])
    _write(os.path.join(files, "configs", f"{cfg['name']}.json"), cfg)
    _write(os.path.join(files, "traffic", "offline-sentences.json"), {**cell.traffic, "rows": 8})
    with open(os.path.join(ROOT, "benchmark", "traffic", "words.txt"), encoding="utf-8") as f:
        words = f.read()
    with open(os.path.join(files, "traffic", "words.txt"), "w", encoding="utf-8") as f:
        f.write(words)
    _write(os.path.join(files, "workloads", f"{CELL}.json"), {**cell.workload, "sample_rows": 3})
    path = os.path.join(tmp, "BENCHMARK.json")
    _write(path, spec)
    return path, files


def run_tiny(monkeypatch, tmp, trace=False, control=None, seed=7):
    from benchmark import run

    bench_json, files = tiny_files(str(tmp))
    real = core.load_cell
    monkeypatch.setattr(core, "load_cell", lambda name, b=None, f=None: real(name, bench_json, files))
    return run.run_cell(CELL, seed, 0.1, trace, device="cpu", control=control)


def test_cell_runs_to_correct_and_reads_its_metrics(tmp_path, monkeypatch):
    res = run_tiny(monkeypatch, tmp_path)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] % 8 == 0, res["checks"]  # whole passes
    assert set(res["metrics"]) == {"audio_s_per_s", "setup_s"} and res["metrics"]["audio_s_per_s"]["value"] > 0
    checks = res["checks"]
    assert set(checks) == {"logit_err", "draw_mismatch", "wave_err", "departures"}
    # float32 against float32: rounding of the summation order only
    assert checks["logit_err"]["value"] < 1e-5 and checks["wave_err"]["value"] < 1e-5
    assert checks["draw_mismatch"]["value"] == 0 and checks["departures"]["value"] == 0


def test_traced_run_reads_the_program_side_metrics(tmp_path, monkeypatch):
    res = run_tiny(monkeypatch, tmp_path, trace=True)
    assert res["correct"] is True and "breakdown" in res
    got = res["metrics"]
    # no kernel runs on the CPU: the device readers find nothing; the program's span and counters do
    assert {"decode_ms_per_position.parler", "mfu.parler"} <= set(got)
    assert "decode_attn_roofline.parler" not in got
    assert got["decode_ms_per_position.parler"]["value"] > 0 and got["mfu.parler"]["value"] > 0


def _codes_shifted(monkeypatch):
    """Every row's codes handed back one frame late."""
    import f5tts_tpu_torch.engine.ar_engine as ar

    real = ar.ParlerTTSEngine.synthesize_rows
    monkeypatch.setattr(ar.ParlerTTSEngine, "synthesize_rows",
                        lambda self, rows: [(w, np.roll(c, 1, axis=1)) for w, c in real(self, rows)])


def _dac_altered(monkeypatch):
    import f5tts_tpu_torch.models.parler as P

    real = P.dac_decode_codes
    monkeypatch.setattr(P, "dac_decode_codes", lambda *a, **kw: real(*a, **kw) * 0.9)


def _stream_reseeded(monkeypatch):
    """Each row draws from another stream than its seed's."""
    import f5tts_tpu_torch.models.parler as P

    real = P._position_seed
    monkeypatch.setattr(P, "_position_seed", lambda seed, row_seed, j: real(seed, row_seed + 1, j))


FAULTS = {"codes_shifted": _codes_shifted, "dac_altered": _dac_altered, "stream_reseeded": _stream_reseeded}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_makes_the_run_incorrect(tmp_path, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res = run_tiny(monkeypatch, tmp_path)
    assert res["correct"] is False, res["checks"]


def test_fp8_control_is_refused(tmp_path, monkeypatch):
    res = run_tiny(monkeypatch, tmp_path, control="reference:fp8")
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["departures"]["value"] == 0


def test_a_program_without_the_replay_fails_at_once(tmp_path, monkeypatch):
    import f5tts_tpu_torch.models.parler as P

    monkeypatch.delattr(P, "parler_replay_logits")
    with pytest.raises(RuntimeError, match="parler_replay_logits"):
        run_tiny(monkeypatch, tmp_path)


# ---------------------------------------------------------------------------
# arithmetic against hand counts (2 FLOPs a multiply-add)
# ---------------------------------------------------------------------------

M = core.load_cell(CELL).config["model"]


def test_row_position_flops_at_the_published_widths():
    # per layer: q|k|v 2*1024*3072, o 2*1024^2, cross q and o 2 * 2*1024^2, fc1 + fc2 2 * 2*1024*4096,
    # attention products 4 * (keys + cross) * 1024; then 9 heads of 1024 x 1088
    per_layer = 6_291_456 + 2_097_152 + 4_194_304 + 16_777_216 + 4 * (300 + 64) * 1024
    assert BP.row_position_flops(M, 300, 64) == 24 * per_layer + 2 * 1024 * 9 * 1088


def test_prefill_and_encoder_flops():
    n, cross = 65, 64
    per_layer = 65 * 29_360_128 + 4 * 1024 * (65 * 66 / 2 + 65 * 64) + 64 * 2 * 2 * 1024 * 1024
    assert BP.prefill_flops(M, n, cross) == 24 * per_layer + 2 * 1024 * 9 * 1088
    # T5 token: q, k, v 3 * 2*1024*1024, o 2*1024^2, wi_0 wi_1 wo 3 * 2*1024*2816, products 4 * 64 * 1024
    assert BP.encoded_token_flops(M, 64) == 24 * (6_291_456 + 2_097_152 + 17_301_504 + 262_144)


def test_dac_frame_flops():
    want = (2 * 9 * 8 * 1024 + 2 * 7 * 1024 * 1536
            + 2 * 1536 * 768 * 16 * 1 + 3 * (2 * 7 + 2) * 768**2 * 8
            + 2 * 768 * 384 * 16 * 8 + 3 * 16 * 384**2 * 64
            + 2 * 384 * 192 * 8 * 64 + 3 * 16 * 192**2 * 256
            + 2 * 192 * 96 * 4 * 256 + 3 * 16 * 96**2 * 512
            + 2 * 7 * 96 * 512)
    assert BP.dac_frame_flops(M) == want
    assert 1.5e9 < want < 1.7e9  # ~138 GFLOP a second of audio at 86.13 frames/s


def test_decode_attn_bytes():
    # 32 rows, 24 layers: K and V of 300 cached and 64 encoder positions, q and o of both calls, 2 bytes each
    assert BP.decode_attn_bytes(M, 32, 300, 64) == 24 * 32 * 2 * (2 * 364 * 1024 + 4 * 1024)


def test_roofline_reader_counts_the_valid_prefix(monkeypatch):
    from benchmark.metrics import decode_attn_roofline_parler as reader
    from benchmark.trace import Trace

    cell = core.load_cell(CELL)
    ctx = core.Context(cell=cell, seed=1, seconds=1.0, trace=True)
    ctx.traced = Trace(window_s=1.0, busy_s=1.0, kernels={"void decode_attn<bf16>": [0.5, 21024]})
    ctx.traced_counters["timer"] = {"counters": {"parler.flushes": 1, "parler.rows": 32, "parler.positions": 438}}
    keys = sum(65 + j for j in range(1, 439))
    want = 24 * 32 * 2 * (2 * (keys + 438 * 64) * 1024 + 438 * 4 * 1024) / 3.35e12
    assert reader.read(ctx) == pytest.approx(100 * want / 0.5, rel=1e-12)
