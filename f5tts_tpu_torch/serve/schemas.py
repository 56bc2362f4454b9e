"""Request schema of ``POST /v1/audio/speech`` (counterpart of
``f5tts_tpu/serve/schemas.py``), as a stdlib dataclass: the same fields,
defaults, bounds and validators as the JAX package's pydantic model. A
violation raises ``ValueError`` (the route answers 400)."""

from __future__ import annotations

import re
from dataclasses import dataclass, fields

from f5tts_tpu_torch.utils.config import SUPPORTED_LANGUAGES

MAX_TEXT_CHARS = 100_000


# ASCII digits only: ``\d`` would take every Unicode decimal digit, which
# pydantic refuses
_FLOAT_STR = re.compile(r"[+-]?([0-9]+(\.[0-9]*)?|\.[0-9]+)([eE][+-]?[0-9]+)?|[+-]?(nan|inf|infinity)", re.IGNORECASE)
_INT_STR = re.compile(r"[+-]?[0-9]+(_[0-9]+)*(\.0+)?")


def _float_str(t: str) -> float | None:
    """A float string as pydantic parses it, else None: the stripped string
    as it stands, or, failing that, the unstripped string with its
    underscores removed, where none leads, trails or doubles."""
    if _FLOAT_STR.fullmatch(t.strip()):
        return float(t.strip())
    if "_" in t and not (t.startswith("_") or t.endswith("_") or "__" in t):
        bare = t.replace("_", "")
        if _FLOAT_STR.fullmatch(bare):
            return float(bare)
    return None


def _number(name: str, v, lo: float, hi: float, kind):
    """``v`` as ``kind`` within ``[lo, hi]``, coerced as pydantic's lax mode
    coerces JSON values: booleans and numeric strings (surrounding spaces
    allowed) pass, and an int field takes a float or string with no
    fractional part; NaN and infinities fail the bounds."""
    if isinstance(v, str):
        if kind is int:
            t = v.strip()
            if not _INT_STR.fullmatch(t):
                raise ValueError(f"{name} must be a number, got {v!r}")
            v = int(t.split(".")[0])
        else:
            f = _float_str(v)
            if f is None:
                raise ValueError(f"{name} must be a number, got {v!r}")
            v = f
    elif not isinstance(v, (int, float)):
        raise ValueError(f"{name} must be a number, got {v!r}")
    if kind is int:
        if isinstance(v, float):
            if not v.is_integer():
                raise ValueError(f"{name} must be an integer, got {v!r}")
        v = int(v)
    else:
        v = float(v)
    if not lo <= v <= hi:
        raise ValueError(f"{name} must be in [{lo}, {hi}], got {v!r}")
    return v


def _optional_str(name: str, v):
    if v is not None and not isinstance(v, str):
        raise ValueError(f"{name} must be a string, got {v!r}")
    return v


@dataclass
class SpeechRequest:
    """``text`` is the reference API's field; ``input`` an OpenAI-style alias.
    The voice-cloning fields extend the reference's single fixed voice."""

    text: str = ""
    input: str = ""
    voice: str | None = None  # named voice from the voices dir
    description: str | None = None  # style description (Parler branch)
    ref_text: str | None = None
    language: str | None = None
    speed: float = 1.0  # 0.3 .. 3
    # model evals per guidance branch; None = the server's configured default
    nfe_step: int | None = None  # 1 .. 128
    cfg_strength: float = 2.0  # 0 .. 10
    seed: int | None = None
    response_format: str = "wav"
    # "strict": solve with the embedded error estimate and escalate to the
    # exact reference recipe (euler, 32 steps) past the engine's threshold
    quality: str = "default"

    def __post_init__(self):
        for name in ("text", "input", "response_format", "quality"):
            if not isinstance(getattr(self, name), str):
                raise ValueError(f"{name} must be a string, got {getattr(self, name)!r}")
        for name in ("voice", "description", "ref_text", "language"):
            _optional_str(name, getattr(self, name))
        self.speed = _number("speed", self.speed, 0.3, 3.0, float)
        self.cfg_strength = _number("cfg_strength", self.cfg_strength, 0.0, 10.0, float)
        if self.nfe_step is not None:
            self.nfe_step = _number("nfe_step", self.nfe_step, 1, 128, int)
        if self.seed is not None:
            self.seed = _number("seed", self.seed, float("-inf"), float("inf"), int)
        if self.quality not in ("default", "strict"):
            raise ValueError("quality must be 'default' or 'strict'")
        for name in ("text", "input"):
            if len(getattr(self, name)) > MAX_TEXT_CHARS:
                raise ValueError("text must be <= 100k characters")
        if self.language is not None and self.language not in SUPPORTED_LANGUAGES:
            raise ValueError(f"unsupported language {self.language!r}")

    @classmethod
    def from_body(cls, body) -> "SpeechRequest":
        """A request from a decoded JSON body; keys that are not fields are
        ignored (OpenAI clients send ``model``), as the pydantic model does."""
        if not isinstance(body, dict):
            raise ValueError(f"request body must be a JSON object, got {type(body).__name__}")
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in body.items() if k in names})

    @property
    def effective_text(self) -> str:
        return self.text or self.input
