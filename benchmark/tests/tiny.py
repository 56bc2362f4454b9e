"""A tiny copy of the benchmark's cells for the CPU tests: the real traffic
files and word list at small sizes, a two-layer DiT and UNetT, a two-layer
Vocos, served in float32 so that the plain kernels run on the CPU."""

from __future__ import annotations

import copy
import json
import os
import shutil

from benchmark.core import BENCH_DIR, ROOT, read_json

TINY_MODEL = {"dim": 64, "depth": 2, "heads": 2, "dim_head": 32, "ff_mult": 2, "mel_dim": 100,
              "text_num_embeds": 479, "text_dim": 32, "conv_layers": 1}
TINY_VOCODER = {"family": "vocos", "input_channels": 100, "dim": 48, "intermediate_dim": 96, "num_layers": 2,
                "n_fft": 1024, "hop_length": 256}


def make_files(tmp, limits: dict | None = None) -> tuple[str, str]:
    """``(BENCHMARK.json path, files directory)`` of the tiny cells."""
    files = os.path.join(tmp, "bench")
    for sub in ("configs", "traffic", "workloads"):
        os.makedirs(os.path.join(files, sub), exist_ok=True)
    shutil.copy(os.path.join(BENCH_DIR, "configs", "vocab.txt"), os.path.join(files, "configs", "vocab.txt"))
    shutil.copy(os.path.join(BENCH_DIR, "traffic", "words.txt"), os.path.join(files, "traffic", "words.txt"))
    spec = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    for c in spec["configs"]:
        cfg = read_json(os.path.join(ROOT, c["file"]))
        cfg["model"] = {**cfg["model"], **TINY_MODEL}
        cfg["vocoder"] = {**TINY_VOCODER}
        cfg["serving"]["engine"]["compute_dtype"] = "float32"
        _write(os.path.join(files, "configs", f"{c['name']}.json"), cfg)
    for w in spec["workloads"]:
        t = read_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
        t = _tiny_traffic(t)
        _write(os.path.join(files, "traffic", f"{w['traffic']}.json"), t)
        wl = read_json(os.path.join(BENCH_DIR, "workloads", f"{w['name']}.json"))
        wl["sample_rows"] = 2
        if limits is not None:
            wl["limits"] = dict(limits)
        _write(os.path.join(files, "workloads", f"{w['name']}.json"), wl)
    path = os.path.join(tmp, "BENCHMARK.json")
    _write(path, spec)
    return path, files


def _tiny_traffic(t: dict) -> dict:
    t = copy.deepcopy(t)
    t["voice_seconds"] = t["voice_seconds"][:2]
    t.update(paragraphs=4, words_min=20, words_max=30)
    return t


def _write(path, obj):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False, indent=1)


def run_tiny(monkeypatch, tmp, workload: str, seconds: float = 0.5, trace: bool = False, control=None,
             workload_overrides: dict | None = None) -> dict:
    """One CPU run of a tiny cell."""
    import torch

    from benchmark import core, run

    torch.set_num_threads(1)  # the test workers share the host's cores
    bench_json, files = make_files(str(tmp))
    if workload_overrides:
        path = os.path.join(files, "workloads", f"{workload}.json")
        _write(path, {**read_json(path), **workload_overrides})
    real = core.load_cell
    monkeypatch.setattr(core, "load_cell", lambda name, bench_json_=None, files_=None: real(name, bench_json, files))
    return run.run_cell(workload, 7, seconds, trace, device="cpu", control=control)
