"""Model cores: DiT / UNetT / MMDiT backbones, the CFM loss, Vocos, BigVGAN,
Parler and the AR mel decoder, as plain functions over parameter trees of
tensors."""


def backbone_fns(model_cfg):
    """``(init_numpy_fn, forward_fn, embed_fn)`` for a backbone config
    (counterpart of ``f5tts_tpu/models/__init__.py:backbone_fns``): the seeded
    numpy init, the forward and the text embedding. The three forwards share
    one signature, ``forward(params, cfg, x, cond, text, time,
    drop_audio_cond, drop_text, mask=..., text_emb=..., compute_dtype=...,
    training=..., dropout_seed=...)``, and the embeds ``embed(params, cfg,
    text, n, drop_text, valid_mask=None)``, so the CFM loss, the sampler, the
    sample hook and the trainer take any of them."""
    from f5tts_tpu_torch.models.convert import init_dit_numpy, init_mmdit_numpy, init_unett_numpy
    from f5tts_tpu_torch.models.dit import DiTConfig, dit_embed, dit_forward
    from f5tts_tpu_torch.models.mmdit import MMDiTConfig, mmdit_forward, mmdit_text_embed
    from f5tts_tpu_torch.models.unett import UNetTConfig, unett_embed, unett_forward

    def mmdit_embed(params, cfg, text, n, drop_text, valid_mask=None):
        # the MMDiT's text stream is token-aligned, not frame-aligned: n and valid_mask do not apply
        return mmdit_text_embed(params, cfg, text, drop_text)

    if isinstance(model_cfg, DiTConfig):
        return init_dit_numpy, dit_forward, dit_embed
    if isinstance(model_cfg, UNetTConfig):
        return init_unett_numpy, unett_forward, unett_embed
    if isinstance(model_cfg, MMDiTConfig):
        return init_mmdit_numpy, mmdit_forward, mmdit_embed
    raise TypeError(f"unknown backbone config {type(model_cfg).__name__}")
