"""The training attention's layout rule on the CPU: which (b, h, n, d)
operands the kernels read through their strides (``readable``,
``kernel_strides``), the 15 strides the launchers pass (``stride_args``), and
the training attention layer handing the kernels head-split views instead of
copies. The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``); these pin the Python around them."""

import pytest
import torch

from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.ops.kernels import flash_attention_train as ft


def _heads(flat, b, n, h, d):
    return flat.reshape(b, n, h, d).transpose(1, 2)


def _accepted():
    b, n, h, d = 2, 64, 3, 64
    qk = torch.zeros((b, n, 2 * h * d), dtype=torch.bfloat16)
    return {
        "contiguous bf16": (torch.zeros((b, h, n, d), dtype=torch.bfloat16), (h * n * d, n * d, d)),
        "contiguous fp32 d 32": (torch.zeros((b, h, n, 32), dtype=torch.float32), (h * n * 32, n * 32, 32)),
        "head split of a projection": (_heads(torch.zeros((b, n, h * d), dtype=torch.bfloat16), b, n, h, d),
                                       (n * h * d, d, h * d)),
        "head split of a fused q|k projection": (_heads(qk[..., : h * d], b, n, h, d), (n * 2 * h * d, d, 2 * h * d)),
        "one head (the span stands for its stride)": (torch.zeros((b, 1, n, d), dtype=torch.bfloat16),
                                                      (n * d, b * n * d, d)),
    }


def _refused():
    b, n, h, d = 2, 64, 3, 64
    x = torch.zeros((b, h, n, d), dtype=torch.bfloat16)
    return {
        "a transposed last axis": x.transpose(2, 3).contiguous().transpose(2, 3),
        "a strided last axis": torch.zeros((b, h, n, 2 * d), dtype=torch.bfloat16)[..., ::2],
        "rows of 136 bytes": torch.zeros((b, h, n, 68), dtype=torch.bfloat16)[..., :64],
        "a start 2 bytes past 16-byte alignment": torch.zeros((b, h, n, 72), dtype=torch.bfloat16)[..., 1:65],
        "an expanded (stride 0) head axis": x[:, :1].expand(b, h, n, d),
        "fp32 rows of 20 bytes": torch.zeros((b, h, n, 5), dtype=torch.float32)[..., :4],
    }


@pytest.mark.parametrize("what", sorted(_accepted()))
def test_kernel_strides_reads_each_operand_through_its_own_strides(what):
    t, want = _accepted()[what]
    assert ft.kernel_strides(t) == want


@pytest.mark.parametrize("what", sorted(_refused()))
def test_kernel_strides_refuses_layouts_the_kernels_do_not_read(what):
    with pytest.raises(ValueError, match="strides"):
        ft.kernel_strides(_refused()[what], "q")


def test_stride_args_orders_the_operands_and_zeroes_the_absent():
    b, n, h, d = 2, 64, 3, 64
    q = torch.zeros((b, h, n, d), dtype=torch.bfloat16)
    v = _heads(torch.zeros((b, n, h * d), dtype=torch.bfloat16), b, n, h, d)
    fwd = ft.stride_args(q=q, k=q, v=v)
    assert fwd == (h * n * d, n * d, d) * 2 + (n * h * d, d, h * d) + (0,) * 6
    bwd = ft.stride_args(q=q, k=q, v=v, dout=v, o=v)
    assert bwd[9:] == (n * h * d, d, h * d) * 2


@pytest.mark.parametrize("what", sorted(_accepted()) + sorted(_refused()))
def test_readable_is_the_rule_kernel_strides_enforces(what):
    """``readable`` (which the backward asks before it copies ``do``) holds
    exactly for the layouts ``kernel_strides`` takes."""
    accepted = what in _accepted()
    t = _accepted()[what][0] if accepted else _refused()[what]
    assert ft.readable(t) is accepted


@pytest.mark.parametrize("rope", [None, "head0", "all"])
def test_training_attention_hands_the_kernels_head_split_views(monkeypatch, rope):
    """v (and q, k without RoPE) reach ``flash_attention_train`` as views of
    the projections; with RoPE, q and k are the RoPE's one copy. Every operand
    passes the kernels' layout rule, and the layer's output is unchanged."""
    from f5tts_tpu_torch.ops.rope import rotary_freqs

    g = torch.Generator().manual_seed(0)
    dim, heads, n = 128, 2, 48
    w = {name: {"w": torch.randn((dim, dim), generator=g) * dim**-0.5, "b": torch.zeros(dim)}
         for name in ("to_q", "to_k", "to_v", "to_out")}
    x = torch.randn((2, n, dim), generator=g)
    freqs = torch.as_tensor(rotary_freqs(n, dim // heads)) if rope else None
    seen = []

    def spy(q, k, v, mask):
        seen.append((q, k, v))
        return ft.flash_attention_train(q, k, v, mask)

    ref = tm.attention(w, x, heads, freqs, None, impl="plain", rope_all_heads=rope == "all")
    monkeypatch.setattr(tm, "flash_attention_train", spy)
    out = tm.attention(w, x, heads, freqs, None, impl="flash", rope_all_heads=rope == "all", training=True)
    (q, k, v), = seen
    assert v._base is not None and not v.is_contiguous()  # a view of the to_v projection, no copy
    if rope is None:
        assert q._base is not None and k._base is not None
    assert all(ft.readable(t) for t in (q, k, v))
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
