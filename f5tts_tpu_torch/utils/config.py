"""Server settings and deployment profiles (counterpart of
``f5tts_tpu/utils/config.py``): env settings (``F5TPU_<FIELD>``), JSON
deployment profiles choosing per-language model stacks, and the server's
argparse flags. ``device`` is ``"cuda"`` unless the caller asks for the CPU
(``--device cpu`` / ``F5TPU_DEVICE=cpu``); without a GPU the engine raises.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from dataclasses import dataclass, replace

RATE_LIMIT_RE = re.compile(r"^\d+/(second|minute|hour|day)$")

# FLORES-style language codes supported by IndicF5-class models
# (config/constants.py:6-16)
SUPPORTED_LANGUAGES = {
    "asm_Beng", "ben_Beng", "brx_Deva", "doi_Deva", "eng_Latn", "gom_Deva",
    "guj_Gujr", "hin_Deva", "kan_Knda", "kas_Arab", "kas_Deva", "mai_Deva",
    "mal_Mlym", "mar_Deva", "mni_Beng", "mni_Mtei", "npi_Deva", "ory_Orya",
    "pan_Guru", "san_Deva", "sat_Olck", "snd_Arab", "snd_Deva", "tam_Taml",
    "tel_Telu", "urd_Arab", "kas_Arab_2", "mni_Mtei_2", "snd_Deva_2",
    "asm_Beng_2", "guj_Gujr_2", "mal_Mlym_2", "pan_Guru_2", "ory_Orya_2",
}


@dataclass
class Settings:
    host: str = "0.0.0.0"
    port: int = 7860
    speech_rate_limit: str = "5/minute"
    chat_rate_limit: str = "100/minute"
    device: str = "cuda"  # "cuda" | "cpu" (the kernels' plain versions)
    dtype: str = "bfloat16"
    lazy_load_model: bool = False
    api_key: str = ""  # empty = auth disabled (the reference documents but never enforces auth)
    tts_ckpt: str = ""
    tts_vocab: str = ""
    vocoder_ckpt: str = ""
    vocoder_type: str = "vocos"  # "vocos" | "bigvgan" (reference --vocoder_name; env F5TPU_VOCODER_TYPE)
    # TTS branch: "f5" (flow matching, default) | "parler" (the AR branch the
    # reference's deployment config names, dhwani_config.json:81)
    tts_model: str = "f5"
    parler_ckpt: str = ""  # full ParlerTTSForConditionalGeneration .pt/.safetensors
    parler_tokenizer: str = ""  # local dir with the T5 tokenizer files
    parler_max_frames: int = 430  # ~5 s at the 44.1 kHz DAC's 86.13 frames/s
    parler_prompt_pad: int = 256  # token budget per utterance (400 when over)
    parler_desc_pad: int = 128  # token budget for the style description
    parler_default_description: str = "A female speaker with clear natural speech."
    voices_dir: str = ""
    demo_tiny: bool = False
    max_batch: int = 32
    batch_wait_ms: float = 15.0
    warmup: bool = True  # pre-compile the smallest bucket at load
    # comma lists of batch / duration buckets to pre-compile at load (every
    # distinct (duration, batch, knob) program otherwise pays a cold compile
    # on its first request); empty warmup_buckets = smallest duration bucket
    warmup_batches: str = "1"
    warmup_buckets: str = ""
    config_name: str = ""
    # ODE integrator + NFE (model evals per guidance branch). Empty/0 = the
    # certified serving default (ralston RK2 @ NFE 20 — BENCH.md round-2
    # certification); ode_method=euler nfe=32 = the exact reference recipe.
    ode_method: str = ""  # euler | midpoint | heun | ralston | rk4
    nfe: int = 0
    # training-free sampler accelerations (BENCH.md measurements); empty/1 =
    # the reference's exact always-guided behavior. Euler-only knobs: setting
    # either one switches the integrator to euler unless ode_method says so.
    cfg_interval: str = ""  # "lo,hi" guidance interval (arXiv:2404.07724)
    cfg_cache: int = 1  # null-branch refresh period k (arXiv:2509.09748 family)
    # long-form throughput: cap chunks so ref+generated frames fit this bucket
    # (EngineConfig.chunk_frames_budget). 0 = engine default (1024, measured
    # ~1.3x faster per generated frame than the reference's ~25 s chunks);
    # -1 = exact reference chunking budget (no cap); >0 = explicit bucket.
    chunk_budget: int = 0
    # cross-request batching strategy: "window" = micro-batching of co-arriving
    # jobs (engine/batcher.py); "step" = step-level continuous batching with
    # mid-solve join/leave at ODE-segment boundaries (engine/step_batcher.py);
    # "auto" (default) = step batching with a load-adaptive dispatch policy —
    # at low load the sole group's segments chain without host ticks (window-
    # grade dispatch cost), under load per-segment admission resumes. auto
    # falls back to window when cfg_cache > 1 (the null-holding knob cannot
    # ride mixed-progress batches); batcher=step with cfg_cache errors.
    batcher: str = "auto"
    # ODE intervals per step-batcher segment (join-latency granularity)
    batcher_segment_intervals: int = 2

    def __post_init__(self):
        for name in ("speech_rate_limit", "chat_rate_limit"):
            v = getattr(self, name)
            if v and not RATE_LIMIT_RE.match(v):
                raise ValueError(f"{name} must look like '5/minute', got {v!r}")
        # fail sampler-acceleration typos at startup, not per-request
        if self.cfg_interval:
            from f5tts_tpu_torch.sampling.euler import parse_cfg_interval

            parse_cfg_interval(self.cfg_interval)
            if self.cfg_cache > 1:
                raise ValueError("cfg_interval and cfg_cache are mutually exclusive")
        if self.cfg_cache < 1:
            raise ValueError("cfg_cache must be >= 1")
        if self.ode_method:
            from f5tts_tpu_torch.sampling.euler import EVALS_PER_STEP

            if self.ode_method not in EVALS_PER_STEP:
                raise ValueError(f"ode_method must be one of {sorted(EVALS_PER_STEP)}, got {self.ode_method!r}")
            if self.ode_method != "euler" and (self.cfg_interval or self.cfg_cache > 1):
                raise ValueError("cfg_interval/cfg_cache are euler-only knobs")
        if self.nfe < 0:
            raise ValueError("nfe must be >= 0 (0 = method default)")
        if self.vocoder_type not in ("vocos", "bigvgan"):
            raise ValueError(f"vocoder_type must be vocos|bigvgan, got {self.vocoder_type!r}")
        if self.tts_model not in ("f5", "parler"):
            raise ValueError(f"tts_model must be f5|parler, got {self.tts_model!r}")
        if self.batcher not in ("window", "step", "auto"):
            raise ValueError(f"batcher must be window|step|auto, got {self.batcher!r}")
        if self.batcher == "step" and self.cfg_cache > 1:
            raise ValueError(
                "batcher=step cannot serve cfg_cache samplers (held null "
                "velocity vs mixed-progress batches); use batcher=window "
                "or auto (auto falls back to window)")
        if self.batcher_segment_intervals < 1:
            raise ValueError("batcher_segment_intervals must be >= 1")

    @classmethod
    def from_env(cls, **overrides) -> "Settings":
        kw = {}
        for f_ in cls.__dataclass_fields__.values():
            env = os.environ.get(f"F5TPU_{f_.name.upper()}")
            if env is not None:
                if f_.type in ("int",):
                    kw[f_.name] = int(env)
                elif f_.type in ("float",):
                    kw[f_.name] = float(env)
                elif f_.type in ("bool",):
                    kw[f_.name] = env.lower() in ("1", "true", "yes")
                else:
                    kw[f_.name] = env
        kw.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**kw)


def load_deployment_config(path: str, config_name: str, settings: Settings) -> Settings:
    """Merge one named profile of a dhwani-style JSON deployment config
    (``core/managers.py:88-102`` semantics: validate name, overwrite fields)."""
    with open(path, encoding="utf-8") as f:
        cfg = json.load(f)
    specific = cfg.get("specific_configs", cfg)
    if config_name not in specific:
        raise ValueError(f"unknown config {config_name!r}; have {sorted(specific)}")
    profile = specific[config_name]
    g = cfg.get("global_settings", {})
    updates = {}
    for key in ("host", "port", "speech_rate_limit", "chat_rate_limit", "device", "dtype"):
        if key in g:
            updates[key] = g[key]
    if "lazy_load" in g:
        updates["lazy_load_model"] = bool(g["lazy_load"])
    for key in ("tts_ckpt", "tts_vocab", "vocoder_ckpt", "voices_dir", "vocoder_type",
                "tts_model", "parler_ckpt", "parler_tokenizer"):
        if key in profile:
            updates[key] = profile[key]
    updates["config_name"] = config_name
    return replace(settings, **updates)


def parse_rate_limit(spec: str) -> tuple[int, float]:
    """'5/minute' -> (5, 60.0 seconds)."""
    n, unit = spec.split("/")
    seconds = {"second": 1.0, "minute": 60.0, "hour": 3600.0, "day": 86400.0}[unit]
    return int(n), seconds


def parse_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("f5tts_tpu_torch.serve.server")
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--config", default=None, help="name of deployment profile")
    p.add_argument("--config-file", default=None, help="deployment JSON path")
    p.add_argument("--demo-tiny", action="store_true")
    p.add_argument("--tts-ckpt", default=None)
    p.add_argument("--tts-vocab", default=None)
    p.add_argument("--vocoder-ckpt", default=None)
    p.add_argument("--voices-dir", default=None)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default cuda (F5TPU_DEVICE); cpu runs the kernels' plain versions")
    return p.parse_args(argv)
