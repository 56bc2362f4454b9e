"""Indic chat / translation pipelines (capability parity with the reference's
unmounted routers ``routes/chat.py`` and ``routes/translate.py``).

The reference wires: translate(indic -> en) -> LLM chat -> translate(en ->
indic), plus direct IndicTrans2 translation; both depend on external models
the repo never ships (the routers are defined but not mounted,
``main.py:92-93``). Here the orchestration is implemented natively and the
model backends are pluggable + gated: local HF model dirs via env
(``F5TPU_LLM_MODEL``, ``F5TPU_TRANSLATE_MODEL``) — a zero-egress build refuses
hub ids with a clear error instead of hanging on a download.

Copy of ``f5tts_tpu/serve/chat.py``: host-side, and the port imports nothing of
the JAX package."""

from __future__ import annotations

import os

_llm = None
_translator = None

LLM_MODEL = os.environ.get("F5TPU_LLM_MODEL", "")
TRANSLATE_MODEL = os.environ.get("F5TPU_TRANSLATE_MODEL", "")


def _require_local(path: str, env: str):
    if not path or not os.path.isdir(path):
        raise ImportError(f"needs local weights: set {env} to a model directory (got {path!r})")


def _llm_pipeline():
    global _llm
    if _llm is None:
        _require_local(LLM_MODEL, "F5TPU_LLM_MODEL")
        from transformers import pipeline

        _llm = pipeline("text-generation", model=LLM_MODEL, device="cpu")
    return _llm


def _translate_components():
    global _translator
    if _translator is None:
        _require_local(TRANSLATE_MODEL, "F5TPU_TRANSLATE_MODEL")
        from transformers import AutoModelForSeq2SeqLM, AutoTokenizer

        tok = AutoTokenizer.from_pretrained(TRANSLATE_MODEL)
        model = AutoModelForSeq2SeqLM.from_pretrained(TRANSLATE_MODEL)
        model.eval()
        _translator = (tok, model)
    return _translator


def preprocess_batch(sentences: list[str], src_lang: str, tgt_lang: str) -> list[str]:
    """IndicProcessor.preprocess_batch contract (``routes/translate.py:30-31``):
    the normalized sentence prefixed with its ``src_lang tgt_lang`` FLORES tag
    tokens — how IndicTrans2-family checkpoints encode the language pair.
    (Script normalization/transliteration is the checkpoint tokenizer's job.)
    """
    return [f"{src_lang} {tgt_lang} {s.strip()}" for s in sentences]


def postprocess_batch(texts: list[str], lang: str) -> list[str]:
    """IndicProcessor.postprocess_batch contract (``routes/translate.py:75``)."""
    return [t.strip() for t in texts]


def translate(sentences: list[str], src_lang: str, tgt_lang: str,
              max_length: int = 256, num_beams: int = 5) -> list[str]:
    """IndicTrans2-contract batch translation (``routes/translate.py:29-76``):
    preprocess (tag prefix) -> tokenize padding=longest -> beam-5 generate
    max_length 256 -> batch_decode skip-special -> postprocess."""
    import torch

    tok, model = _translate_components()
    batch = preprocess_batch(sentences, src_lang, tgt_lang)
    inputs = tok(batch, truncation=True, padding="longest",
                 return_tensors="pt", return_attention_mask=True)
    inputs.pop("token_type_ids", None)  # emitted by some fast tokenizers; seq2seq generate rejects it
    with torch.no_grad():
        generated = model.generate(
            **inputs, use_cache=True, min_length=0, max_length=max_length,
            num_beams=num_beams, num_return_sequences=1,
        )
    texts = tok.batch_decode(generated, skip_special_tokens=True,
                             clean_up_tokenization_spaces=True)
    return postprocess_batch(texts, tgt_lang)


def indic_chat(prompt: str, language: str, max_new_tokens: int = 256) -> str:
    """Translate-in -> chat -> translate-out sandwich (``routes/chat.py:17-63``).

    English prompts skip the translation legs, as in the reference.
    """
    is_english = language.startswith("eng")
    en_prompt = prompt if is_english else translate([prompt], language, "eng_Latn")[0]
    if not en_prompt.strip():  # empty translation would crash generation
        en_prompt = prompt
    llm = _llm_pipeline()
    reply = llm(en_prompt, max_new_tokens=max_new_tokens, return_full_text=False)[0]["generated_text"].strip()
    if is_english:
        return reply
    return translate([reply], "eng_Latn", language)[0]


VLM_MODEL = os.environ.get("F5TPU_VLM_MODEL", "")
_vlm = None


def _vlm_pipeline():
    global _vlm
    if _vlm is None:
        _require_local(VLM_MODEL, "F5TPU_VLM_MODEL")
        from transformers import pipeline

        _vlm = pipeline("image-text-to-text", model=VLM_MODEL, device="cpu")
    return _vlm


def visual_query(image, query: str, src_lang: str, tgt_lang: str, max_new_tokens: int = 256) -> str:
    """Image + question -> answer with the translate-in/out sandwich
    (``routes/chat.py:65-241`` visual-query semantics; English legs skipped)."""
    en_query = query if src_lang.startswith("eng") else translate([query], src_lang, "eng_Latn")[0]
    pipe = _vlm_pipeline()
    messages = [{"role": "user", "content": [
        {"type": "image", "image": image}, {"type": "text", "text": en_query}]}]
    answer = pipe(text=messages, max_new_tokens=max_new_tokens, return_full_text=False)
    answer = answer[0]["generated_text"].strip()
    if tgt_lang.startswith("eng"):
        return answer
    return translate([answer], "eng_Latn", tgt_lang)[0]


def document_query_batch(images, query: str, src_lang: str, tgt_lang: str) -> list[str]:
    """Per-page visual query over a document (``routes/chat.py:242-440``)."""
    return [visual_query(img, query, src_lang, tgt_lang) for img in images]
