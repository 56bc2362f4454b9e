"""Character tokenizer with the reference's conventions (copy of
``f5tts_tpu/text/tokenizer.py``, kept so the port imports nothing of the JAX
package).

Contract (``model/utils.py:81-177``):
- vocab file: one char per line, line index = id; space must be id 0 (doubles
  as the unknown-char id).
- ``encode`` maps chars to ids with unk -> 0 and pads batches with -1 (the
  model shifts +1 so -1 becomes the filler token 0).
- ``convert_char_to_pinyin``: Chinese chars -> TONE3 pinyin with a
  space-separator; everything else — including all Indic scripts — passes
  through character-by-character. jieba/pypinyin are optional (not in this
  image): without them the Chinese branch degrades to raw-char pass-through,
  which is exact for Indic/Latin input (the serving use case).
"""

from __future__ import annotations

import numpy as np

try:  # optional Chinese G2P (parity with utils.py:136-177)
    import jieba  # type: ignore
    from pypinyin import Style, lazy_pinyin  # type: ignore

    _HAS_PINYIN = True
except Exception:  # pragma: no cover - absent in this image
    _HAS_PINYIN = False

_CUSTOM_TRANS = str.maketrans({";": ",", "“": '"', "”": '"', "‘": "'", "’": "'"})


def _is_chinese(c: str) -> bool:
    return "㄀" <= c <= "鿿"


def convert_char_to_pinyin(text_list: list[str], polyphone: bool = True) -> list[list[str]]:
    """Token lists per input string; Chinese -> pinyin when available."""
    out = []
    for text in text_list:
        text = text.translate(_CUSTOM_TRANS)
        char_list: list[str] = []
        if _HAS_PINYIN:
            for seg in jieba.cut(text):
                seg_bytes = len(bytes(seg, "UTF-8"))
                if seg_bytes == len(seg):  # pure ascii
                    if char_list and seg_bytes > 1 and char_list[-1] not in " :'\"":
                        char_list.append(" ")
                    char_list.extend(seg)
                elif polyphone and seg_bytes == 3 * len(seg):  # pure CJK
                    seg_ = lazy_pinyin(seg, style=Style.TONE3, tone_sandhi=True)
                    for i, c in enumerate(seg):
                        if _is_chinese(c):
                            char_list.append(" ")
                        char_list.append(seg_[i])
                else:
                    for c in seg:
                        if ord(c) < 256:
                            char_list.extend(c)
                        elif _is_chinese(c):
                            char_list.append(" ")
                            char_list.extend(lazy_pinyin(c, style=Style.TONE3, tone_sandhi=True))
                        else:
                            char_list.append(c)
        else:
            char_list.extend(text)
        out.append(char_list)
    return out


class Tokenizer:
    def __init__(self, vocab_char_map: dict[str, int]):
        if vocab_char_map.get(" ") != 0:
            raise ValueError("space must have id 0 in the vocab (used as unknown)")
        self.vocab_char_map = vocab_char_map
        self.vocab_size = len(vocab_char_map)

    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        vocab: dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line[:-1] if line.endswith("\n") else line] = i
        return cls(vocab)

    @classmethod
    def from_texts(cls, texts: list[str]) -> "Tokenizer":
        """Build an ad-hoc vocab (space first) — for tests and toy training."""
        chars = sorted({c for t in texts for c in t if c != " "})
        return cls({" ": 0, **{c: i + 1 for i, c in enumerate(chars)}})

    def encode(self, texts: list[str], pad_to: int | None = None, pinyin: bool = True) -> np.ndarray:
        """``(b, nt) int32`` id batch, padded with -1."""
        token_lists = convert_char_to_pinyin(texts) if pinyin else [list(t) for t in texts]
        ids = [[self.vocab_char_map.get(c, 0) for c in toks] for toks in token_lists]
        max_len = max(pad_to if pad_to is not None else max((len(r) for r in ids), default=1), 1)
        batch = np.full((len(ids), max_len), -1, dtype=np.int32)
        for i, row in enumerate(ids):
            m = min(len(row), max_len)  # curtail over-long rows (model curtails to mel len anyway)
            batch[i, :m] = row[:m]
        return batch
