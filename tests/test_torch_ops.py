"""Parity of the PyTorch port's ops (``f5tts_tpu_torch/ops``) with the JAX
package on the CPU: masks, RoPE, attention, mel front end, iSTFT, and the
plain versions of the two CUDA kernels against the Pallas kernels in
interpret mode. Inputs come from numpy with fixed seeds; tolerances are
stated per test (fp32 throughout, JAX matmul precision ``highest`` from
``tests/conftest.py``, torch TF32 off)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from f5tts_tpu.ops import attention as j_attn
from f5tts_tpu.ops import masks as j_masks
from f5tts_tpu.ops import mel as j_mel
from f5tts_tpu.ops import rope as j_rope
from f5tts_tpu.ops import stft as j_stft
from f5tts_tpu.ops.pallas.conv_pos import conv_pos_pallas
from f5tts_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from f5tts_tpu_torch.ops import attention as t_attn
from f5tts_tpu_torch.ops import masks as t_masks
from f5tts_tpu_torch.ops import mel as t_mel
from f5tts_tpu_torch.ops import rope as t_rope
from f5tts_tpu_torch.ops import stft as t_stft
from f5tts_tpu_torch.ops.kernels import conv_pos as t_conv
from f5tts_tpu_torch.ops.kernels import flash_attention as t_flash

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5  # fp32 ops on identical inputs


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(torch_out, jax_out, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(torch_out.detach().cpu().numpy(), np.asarray(jax_out), atol=atol, rtol=rtol)


def test_masks():
    lens = np.array([0, 3, 7], np.int32)
    _close(t_masks.lens_to_mask(_t(lens), 7), j_masks.lens_to_mask(jnp.asarray(lens), 7))
    start, end = np.array([0, 2, 5], np.int32), np.array([3, 2, 7], np.int32)
    _close(t_masks.mask_from_start_end_indices(7, _t(start), _t(end)),
           j_masks.mask_from_start_end_indices(7, jnp.asarray(start), jnp.asarray(end)))


def test_rope_tables_and_rotation():
    np.testing.assert_array_equal(t_rope.precompute_freqs_cis(32, 50), j_rope.precompute_freqs_cis(32, 50))
    np.testing.assert_array_equal(t_rope.rotary_freqs(40, 16), j_rope.rotary_freqs(40, 16))
    rng = np.random.default_rng(0)
    freqs = j_rope.rotary_freqs(24, 16)
    flat = rng.standard_normal((2, 24, 3 * 16)).astype(np.float32)  # 3 heads of 16, head-0-only quirk
    _close(t_rope.apply_rotary(_t(flat), _t(freqs)), j_rope.apply_rotary(jnp.asarray(flat), jnp.asarray(freqs)))
    heads = rng.standard_normal((2, 3, 24, 16)).astype(np.float32)
    _close(t_rope.apply_rotary_per_head(_t(heads), _t(freqs)),
           j_rope.apply_rotary_per_head(jnp.asarray(heads), jnp.asarray(freqs)))


@pytest.mark.parametrize("with_mask", [False, True])
def test_sdpa(with_mask):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 3, 40, 16)).astype(np.float32) for _ in range(3))
    mask = np.arange(40)[None] < np.array([[40], [23]]) if with_mask else None
    out = t_attn.sdpa(_t(q), _t(k), _t(v), _t(mask) if with_mask else None)
    ref = j_attn.sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask) if with_mask else None)
    _close(out, ref)


@pytest.mark.parametrize("flavor", ["vocos", "bigvgan"])
def test_log_mel_spectrogram(flavor):
    rng = np.random.default_rng(2)
    wav = (0.1 * rng.standard_normal((2, 6000))).astype(np.float32)
    cfg_t = t_mel.MelConfig(flavor=flavor)
    cfg_j = j_mel.MelConfig(flavor=flavor)
    np.testing.assert_allclose(t_mel.mel_filterbank(24000, 1024, 100), j_mel.mel_filterbank(24000, 1024, 100), atol=0)
    _close(t_mel.log_mel_spectrogram(_t(wav), cfg_t), j_mel.log_mel_spectrogram(jnp.asarray(wav), cfg_j),
           atol=1e-4, rtol=1e-5)  # log of fp32 FFT magnitudes: two FFT libraries


def test_bucketed_log_mel():
    rng = np.random.default_rng(3)
    wav = (0.1 * rng.standard_normal(9000)).astype(np.float32)
    out = t_mel.bucketed_log_mel(wav, t_mel.MelConfig(), bucket=4096, device="cpu")
    ref = j_mel.bucketed_log_mel(wav, j_mel.MelConfig(), bucket=4096)
    assert out.shape == ref.shape == (9000 // 256, 100)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-5)


def test_istft_reim():
    rng = np.random.default_rng(4)
    re, im = (rng.standard_normal((2, 12, 513)).astype(np.float32) for _ in range(2))
    out = t_stft.istft_reim(_t(re), _t(im))
    ref = j_stft.istft_reim(jnp.asarray(re), jnp.asarray(im))
    assert tuple(out.shape) == ref.shape == (2, 11 * 256)
    _close(out, ref)


# ---------------------------------------------------------------------------
# plain versions of the CUDA kernels against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,with_mask,rope", [
    (256, False, None), (256, True, None), (384, True, "head0"), (256, True, "all"),
])
def test_flash_attention_plain_matches_pallas(n, with_mask, rope):
    rng = np.random.default_rng(5)
    b, h, d = 2, 2, 64
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    mask = (np.arange(n)[None] < np.array([[n], [n - 77]])) if with_mask else None
    freqs = j_rope.rotary_freqs(n, d) if rope else None
    ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask) if with_mask else None, interpret=True,
                             rope_freqs=jnp.asarray(freqs) if rope else None, rope_all_heads=rope == "all"))
    before = t_flash.flash_attention.launches
    out = t_flash.flash_attention(_t(q), _t(k), _t(v), _t(mask) if with_mask else None,
                                  rope_freqs=_t(freqs) if rope else None, rope_all_heads=rope == "all")
    assert t_flash.flash_attention.launches == before  # CPU tensors take the plain version
    valid = mask if with_mask else np.ones((b, n), bool)
    for bi in range(b):  # padded query rows are don't-care
        np.testing.assert_allclose(out.numpy()[bi][:, valid[bi]], ref[bi][:, valid[bi]], atol=2e-5, rtol=1e-5)


def test_conv_pos_plain_matches_pallas():
    rng = np.random.default_rng(6)
    b, n, c, kw = 2, 128, 128, 31
    w1, w2 = (rng.uniform(-0.1, 0.1, (kw, c // 16, c)).astype(np.float32) for _ in range(2))
    b1, b2 = (rng.uniform(-0.1, 0.1, (c,)).astype(np.float32) for _ in range(2))
    lens = np.array([n, 77], np.int32)  # ragged: row 1's intermediate is zeroed past 77
    x = rng.standard_normal((b, n, c)).astype(np.float32) * (np.arange(n)[None, :, None] < lens[:, None, None])
    ref = np.asarray(conv_pos_pallas(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)), interpret=True,
                                     lens=jnp.asarray(lens)))
    before = t_conv.conv_pos.launches
    out = t_conv.conv_pos(*(_t(a) for a in (x, w1, b1, w2, b2)), lens=_t(lens))
    assert t_conv.conv_pos.launches == before
    valid = np.arange(n)[None, :] < lens[:, None]
    np.testing.assert_allclose(out.numpy()[valid], ref[valid], atol=2e-5, rtol=1e-5)


def test_kernel_wrappers_reject_unsupported_devices():
    x = torch.zeros((1, 1, 8, 32), device="meta")
    with pytest.raises(ValueError, match="cuda"):
        t_flash.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="cuda"):
        t_conv.conv_pos(torch.zeros((1, 8, 32), device="meta"), *(torch.zeros(1, device="meta"),) * 4)
