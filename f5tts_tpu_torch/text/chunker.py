"""Sentence-aware text chunking for long-form synthesis (copy of
``f5tts_tpu/text/chunker.py``, kept so the port imports nothing of the JAX
package).

Parity with ``infer/utils_infer.py:61-88`` (greedy byte-budget packing over a
punctuation split) and the speech-rate-aware budget
``max_chars = ref_bytes / ref_sec * (25 - ref_sec)``
(``utils_infer.py:377``).
"""

from __future__ import annotations

import re

_SPLIT = re.compile(r"(?<=[;:,.!?])\s+|(?<=[；：，。！？])")


def chunk_text(text: str, max_chars: int = 135) -> list[str]:
    chunks: list[str] = []
    current = ""
    for sentence in _SPLIT.split(text):
        sep = " " if sentence and len(sentence[-1].encode("utf-8")) == 1 else ""
        if len(current.encode("utf-8")) + len(sentence.encode("utf-8")) <= max_chars:
            current += sentence + sep
        else:
            if current:
                chunks.append(current.strip())
            current = sentence + sep
    if current:
        chunks.append(current.strip())
    return chunks


def chunk_text_packed(text: str, max_chars: int = 135, topoff_deficit: float = 0.08) -> list[str]:
    """Byte-budget packing with word-boundary top-off (long-form throughput
    mode, NOT the reference contract — ``chunk_text`` is that).

    Clause-greedy packing (reference ``utils_infer.py:61-88`` behavior)
    quantizes chunk sizes to clause boundaries, leaving ~8% of the duration
    bucket unfilled on realistic prose (944/1024 frames measured, BENCH.md
    round-2) — and since a full chunk (ref + gen = bucket) is exactly the
    headline geometry, that unfilled slack IS the entire structural long-form
    throughput gap. This packer fills the remainder with leading *words* of
    the next clause whenever the clause-boundary deficit exceeds
    ``topoff_deficit * max_chars``; chunks whose clause packing already fills
    >= (1 - topoff_deficit) of the budget keep their clause boundary (the
    crossfade then lands on a natural pause, like the reference).

    Chunks concatenate (space-joined) back to the input text modulo
    whitespace normalization — nothing is dropped or duplicated.
    """
    def _cjk(s: str) -> bool:
        # CJK scripts pack without spaces; Indic scripts are multibyte but
        # space-separated (word tokens are correct there)
        return all(0x3000 <= ord(c) <= 0x9FFF or 0xAC00 <= ord(c) <= 0xD7AF
                   or 0xF900 <= ord(c) <= 0xFAFF or 0xFF00 <= ord(c) <= 0xFF65
                   for c in s)

    # tokens: (word, separator-before-when-not-chunk-initial, is-clause-end)
    words: list[tuple[str, str, bool]] = []
    prev_sep = ""  # separator before a sentence: " " after 1-byte-ending
    #              sentences (chunk_text's rule), "" after CJK punctuation
    for sentence in _SPLIT.split(text):
        if not sentence.strip():
            continue
        toks: list[tuple[str, str, bool]] = []
        for w in sentence.split():
            sep = prev_sep if not toks else " "
            if len(w) > 1 and _cjk(w):
                # unspaced CJK run: each char is a token, no separator
                toks.append((w[0], sep, False))
                toks.extend((c, "", False) for c in w[1:])
            else:
                toks.append((w, sep, False))
        if not toks:
            continue
        toks[-1] = (toks[-1][0], toks[-1][1], True)  # clause end: close candidate
        words.extend(toks)
        prev_sep = " " if len(sentence.strip()[-1].encode("utf-8")) == 1 else ""

    chunks: list[str] = []
    current: list[str] = []
    cur_bytes = 0

    def close():
        nonlocal current, cur_bytes
        chunks.append("".join(current))
        current, cur_bytes = [], 0

    for w, sep, clause_end in words:
        piece = (sep if current else "") + w
        pb = len(piece.encode("utf-8"))
        if current and cur_bytes + pb > max_chars:
            close()
            piece, pb = w, len(w.encode("utf-8"))
        current.append(piece)
        cur_bytes += pb
        if clause_end and cur_bytes >= (1.0 - topoff_deficit) * max_chars:
            # close at the clause boundary: near-full already, a natural
            # pause beats a few more bytes of fill
            close()
    if current:
        close()
    return chunks


def max_chars_for_ref(ref_text: str, ref_audio_secs: float) -> int:
    """Byte budget per chunk derived from the reference speech rate."""
    return int(len(ref_text.encode("utf-8")) / max(ref_audio_secs, 1e-6) * (25 - ref_audio_secs))


def duration_frames(
    ref_frames: int, ref_text: str, gen_text: str, speed: float = 1.0, fix_duration_secs: float | None = None,
    sample_rate: int = 24000, hop_length: int = 256,
) -> int:
    """Total mel frames (ref + generated) — ``utils_infer.py:446-453``."""
    if fix_duration_secs is not None:
        return int(fix_duration_secs * sample_rate / hop_length)
    ref_bytes = max(len(ref_text.encode("utf-8")), 1)
    gen_bytes = len(gen_text.encode("utf-8"))
    return ref_frames + int(ref_frames / ref_bytes * gen_bytes / speed)
