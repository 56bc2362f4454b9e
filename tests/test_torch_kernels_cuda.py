"""The port's CUDA kernels against their plain PyTorch versions on the card, at
small shapes (``chip_smoke.py`` repeats this at the main-path shapes). Marked
``cuda``: skips without a card. Imports neither JAX nor the JAX package, so it
also runs where JAX is absent:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from f5tts_tpu_torch.ops.kernels import conv_pos as t_conv
from f5tts_tpu_torch.ops.kernels import flash_attention as t_flash
from f5tts_tpu_torch.ops.rope import rotary_freqs


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("rope_all", [False, True])
def test_flash_attention_kernel_matches_plain(dev, dtype, tol, rope_all):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 4, 200, 64), generator=g).to(dev, dtype) for _ in range(3))
    mask = (torch.arange(200)[None] < torch.tensor([[200], [150]])).to(dev)
    freqs = torch.as_tensor(rotary_freqs(200, 64), device=dev)
    before = t_flash.flash_attention.launches
    out = t_flash.flash_attention(q, k, v, mask, rope_freqs=freqs, rope_all_heads=rope_all)
    assert t_flash.flash_attention.launches == before + 1
    ref = t_flash.flash_attention_plain(q.float(), k.float(), v.float(), mask, freqs, rope_all)
    assert float(((out.float() - ref).abs() * mask[:, None, :, None]).max()) < tol


@pytest.mark.cuda
def test_conv_pos_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn((2, 200, 1024), generator=g) * 0.5).to(dev, torch.bfloat16)
    w1, w2 = ((torch.rand((31, 64, 1024), generator=g) - 0.5) * 0.04 for _ in range(2))
    b1, b2 = ((torch.rand(1024, generator=g) - 0.5) * 0.04 for _ in range(2))
    w1, w2, b1, b2 = (t.to(dev, torch.bfloat16) for t in (w1, w2, b1, b2))
    lens = torch.tensor([200, 120], dtype=torch.int32, device=dev)
    before = t_conv.conv_pos.launches
    out = t_conv.conv_pos(x, w1, b1, w2, b2, lens)
    assert t_conv.conv_pos.launches == before + 2  # one launch per layer
    ref = t_conv.conv_pos_plain(x.float(), w1.float(), b1.float(), w2.float(), b2.float(), lens)
    assert float((out.float() - ref).abs().max()) < 3e-2


@pytest.mark.cuda
def test_wrappers_raise_on_unsupported_inputs(dev):
    q = torch.zeros((1, 2, 64, 48), device=dev, dtype=torch.bfloat16)  # head dim 48 is not built
    with pytest.raises(ValueError, match="head dims"):
        t_flash.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        h = torch.zeros((1, 2, 64, 64), device=dev, dtype=torch.float16)
        t_flash.flash_attention(h, h, h)
