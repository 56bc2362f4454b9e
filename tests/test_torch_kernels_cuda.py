"""The port's CUDA kernels against their plain PyTorch versions on the card, at
small shapes (``chip_smoke.py`` repeats this at the main-path shapes). Marked
``cuda``: skips without a card. Imports neither JAX nor the JAX package, so it
also runs where JAX is absent:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from f5tts_tpu_torch.ops.kernels import ablate_attention as t_abl
from f5tts_tpu_torch.ops.kernels import conv_pos as t_conv
from f5tts_tpu_torch.ops.kernels import decode_attention as t_dec
from f5tts_tpu_torch.ops.kernels import flash_attention as t_flash
from f5tts_tpu_torch.ops.kernels import flash_attention_train as t_train
from f5tts_tpu_torch.ops.kernels import quant_matmul as t_quant
from f5tts_tpu_torch.ops.rope import rotary_freqs


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# bf16 d 64 / 128: the wgmma kernel (with the RoPE pre-pass); d 32 and fp32: the mma.sync / CUDA-core kernels
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("rope_all", [False, True])
@pytest.mark.parametrize("b,h,n,d,dead_row", [(2, 4, 200, 64, False), (2, 2, 1000, 64, True), (1, 2, 4096, 64, False),
                                              (2, 2, 200, 128, True), (2, 2, 130, 32, False)])
def test_flash_attention_kernel_matches_plain(dev, dtype, tol, rope_all, b, h, n, d, dead_row):
    g = torch.Generator().manual_seed(n + d)
    q, k, v = (torch.randn((b, h, n, d), generator=g).to(dev, dtype) for _ in range(3))
    mask = (torch.arange(n)[None] < torch.tensor([[n], [n - 77]])[:b]).to(dev)
    if dead_row:
        mask[-1] = False  # every key of the last batch row masked: each key weighs the same
    freqs = torch.as_tensor(rotary_freqs(n, d), device=dev)
    before = t_flash.flash_attention.launches, t_flash.rope_rows.launches
    out = t_flash.flash_attention(q, k, v, mask, rope_freqs=freqs, rope_all_heads=rope_all)
    prepass = int(dtype == torch.bfloat16 and d in (64, 128))  # the wgmma path rotates its rows in a pre-pass
    assert (t_flash.flash_attention.launches, t_flash.rope_rows.launches) == (before[0] + 1, before[1] + prepass)
    assert out.shape == q.shape and out.dtype == dtype
    ref = t_flash.flash_attention_plain(q.float(), k.float(), v.float(), mask, freqs, rope_all)
    rows = mask | ~mask.any(-1, keepdim=True)
    assert float(((out.float() - ref).abs() * rows[:, None, :, None]).max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_attention_reads_head_split_views(dev, dtype, d):
    """(b, h, n, d) views of (b, n, h*d) projections give what the contiguous
    call gives, bit for bit, and the result is a view of a (b, n, h, d) buffer."""
    g = torch.Generator().manual_seed(d)
    b, h, n = 2, 4, 300
    flat = [torch.randn((b, n, h * d), generator=g).to(dev, dtype) for _ in range(3)]
    views = [t.view(b, n, h, d).transpose(1, 2) for t in flat]
    mask = (torch.arange(n)[None] < torch.tensor([[n], [211]])).to(dev)
    freqs = torch.as_tensor(rotary_freqs(n, d), device=dev)
    for rope_all in (False, True):
        out = t_flash.flash_attention(*views, mask, rope_freqs=freqs, rope_all_heads=rope_all)
        dense = t_flash.flash_attention(*(x.contiguous() for x in views), mask, rope_freqs=freqs, rope_all_heads=rope_all)
        given = t_flash.flash_attention(*views, mask, rope_freqs=freqs, rope_all_heads=rope_all,
                                        rope_cos_sin=t_flash.cos_sin_of(freqs))  # cos/sin made once by the caller
        assert torch.equal(out, dense) and torch.equal(out, given)
        assert out.transpose(1, 2).is_contiguous()


# bf16 at group width 64: the fused pair, one launch; the ragged lens cover rows shorter than the kernel (< 31),
# n no multiple of the 256-frame tile, n below the kernel width, batch 1
@pytest.mark.cuda
@pytest.mark.parametrize("n,lens", [(200, (200, 120)), (700, (700, 20)), (300, (13, 256)), (20, (20, 7)), (1024, (1024,)),
                                    (513, (1,))])
def test_conv_pos_kernel_matches_plain(dev, n, lens):
    g = torch.Generator().manual_seed(1 + n)
    b = len(lens)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(n, device=dev)[None] < lens[:, None])[..., None]
    x = ((torch.randn((b, n, 1024), generator=g) * 0.5).to(dev) * mask).to(torch.bfloat16)
    w1, w2 = ((torch.rand((31, 64, 1024), generator=g) - 0.5) * 0.04 for _ in range(2))
    b1, b2 = ((torch.rand(1024, generator=g) - 0.5) * 0.04 for _ in range(2))
    w1, w2, b1, b2 = (t.to(dev, torch.bfloat16) for t in (w1, w2, b1, b2))
    before = t_conv.conv_pos.launches
    out = t_conv.conv_pos(x, w1, b1, w2, b2, lens)
    assert t_conv.conv_pos.launches == before + 1  # the pair in one launch
    ref = t_conv.conv_pos_plain(x.float(), w1.float(), b1.float(), w2.float(), b2.float(), lens)
    assert float((out.float() - ref).abs().max()) < 3e-2  # every row, those at or past lens included


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cg", [(torch.float32, 64), (torch.bfloat16, 8)])
def test_conv_pos_cuda_core_layers_match_plain(dev, dtype, cg):
    """fp32 and group widths other than 64 run the CUDA-core layer twice."""
    g = torch.Generator().manual_seed(cg)
    c, n = 16 * cg, 300
    lens = torch.tensor([300, 90], dtype=torch.int32, device=dev)
    keep = (torch.arange(n, device=dev)[None] < lens[:, None])[..., None]
    x = ((torch.randn((2, n, c), generator=g) * 0.5).to(dev) * keep).to(dtype)
    w1, w2 = (((torch.rand((31, cg, c), generator=g) - 0.5) * 0.1).to(dev, dtype) for _ in range(2))
    b1, b2 = (((torch.rand(c, generator=g) - 0.5) * 0.1).to(dev) for _ in range(2))
    before = t_conv.conv_pos.launches
    out = t_conv.conv_pos(x, w1, b1, w2, b2, lens)
    assert t_conv.conv_pos.launches == before + 2
    ref = t_conv.conv_pos_plain(x.float(), w1.float(), b1, w2.float(), b2, lens)
    assert float((out.float() - ref).abs().max()) < (1e-4 if dtype == torch.float32 else 3e-2)


@pytest.mark.cuda
def test_wrappers_raise_on_unsupported_inputs(dev):
    q = torch.zeros((1, 2, 64, 48), device=dev, dtype=torch.bfloat16)  # head dim 48 is not built
    with pytest.raises(ValueError, match="head dims"):
        t_flash.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        h = torch.zeros((1, 2, 64, 64), device=dev, dtype=torch.float16)
        t_flash.flash_attention(h, h, h)
    x = torch.zeros((1, 2, 64, 64), device=dev, dtype=torch.bfloat16)
    refused = {"other strides": (x, x.transpose(2, 3), x),
               "a strided last axis": (torch.zeros((1, 2, 64, 128), device=dev, dtype=torch.bfloat16)[..., ::2],) * 3,
               "rows of 136 bytes": (torch.zeros((1, 2, 64, 68), device=dev, dtype=torch.bfloat16)[..., :64],) * 3}
    for what, (qq, kk, vv) in refused.items():
        before = t_flash.flash_attention.launches, t_flash.rope_rows.launches
        with pytest.raises(ValueError, match="strides"):
            t_flash.flash_attention(qq, kk, vv, rope_freqs=torch.zeros((64, 64), device=dev))
        assert (t_flash.flash_attention.launches, t_flash.rope_rows.launches) == before, what


def _train_inputs(dev, dtype, n, d, dead_row):
    g = torch.Generator().manual_seed(2)
    q, k, v, do = (torch.randn((2, 3, n, d), generator=g).to(dev, dtype) for _ in range(4))
    mask = (torch.arange(n)[None] < torch.tensor([[n], [n - 37]])).to(dev)
    if dead_row:
        mask[1] = False  # every key of batch row 1 masked
    return q, k, v, do, mask


def _rel_err(out, ref):
    """Max abs error over the reference's peak magnitude (at least 1)."""
    return float((out.float() - ref.float()).abs().max()) / max(1.0, float(ref.float().abs().max()))


# bf16 kernel vs fp32 plain on the same bf16 inputs: o and the gradients within
# 2e-2 / 3e-2 of the peak (p and dS are rounded to bf16 in the kernel), lse
# within 1e-3; fp32 kernel within 1e-4 (summation order only). bf16 d 64 / 128
# forward and d 64 backward: the wgmma kernels (with and without the key bias);
# the rest: mma.sync / CUDA cores.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("n,d,dead_row,masked", [
    (256, 64, False, True), (200, 64, True, True), (130, 32, False, True), (96, 128, False, True),
    (1000, 64, True, True), (1000, 128, False, True),
    (256, 64, False, False), (130, 32, False, False), (96, 128, False, False), (1000, 64, False, False)])
def test_flash_train_kernels_match_plain(dev, dtype, tol, n, d, dead_row, masked):
    q, k, v, do, mask = _train_inputs(dev, dtype, n, d, dead_row)
    mask = mask if masked else None
    f0, b0 = t_train.flash_attention_train_fwd.launches, t_train.flash_attention_train_bwd.launches
    o, lse = t_train.flash_attention_train_fwd(q, k, v, mask)
    dq, dk, dv = t_train.flash_attention_train_bwd(q, k, v, o, lse, do, mask)
    torch.cuda.synchronize()
    assert t_train.flash_attention_train_fwd.launches == f0 + 1
    assert t_train.flash_attention_train_bwd.launches == b0 + 2  # dQ (with D) and dK/dV kernels
    if dead_row:  # every key of batch row 1 masked: lse = -1e30 exactly, as the TPU kernel gives
        assert bool((lse[1] == -1e30).all())
    ref_o, ref_lse = t_train.flash_attention_train_fwd_plain(q.float(), k.float(), v.float(), mask)
    assert _rel_err(o, ref_o) < (2e-2 if dtype == torch.bfloat16 else tol)
    assert float((lse - ref_lse).abs().max()) < (1e-3 if dtype == torch.bfloat16 else 1e-4)
    refs = t_train.flash_attention_train_bwd_plain(q.float(), k.float(), v.float(), ref_o, ref_lse, do.float(), mask)
    for got, ref in zip((dq, dk, dv), refs):
        assert bool(torch.isfinite(got).all())
        assert _rel_err(got, ref) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("masked", [True, False])
def test_flash_train_reads_head_split_views(dev, dtype, d, masked):
    """q, k, v and dO as (b, h, n, d) views of (b, n, h*d) tensors (q and k
    of one fused projection, v and dO apart), each with its own strides, give
    what the same values made contiguous give, bit for bit: o, lse, dq, dk,
    dv. Before the kernels read strides they indexed every operand as
    contiguous and returned wrong values here with no error."""
    g = torch.Generator().manual_seed(5 + d)
    b, h, n = 2, 4, 300
    qk = torch.randn((b, n, 2 * h * d), generator=g).to(dev, dtype)
    q, k = (t.reshape(b, n, h, d).transpose(1, 2) for t in qk.split(h * d, -1))
    v, do = (torch.randn((b, n, h * d), generator=g).to(dev, dtype).view(b, n, h, d).transpose(1, 2)
             for _ in range(2))
    mask = (torch.arange(n)[None] < torch.tensor([[n], [211]])).to(dev) if masked else None
    assert len({t_train.kernel_strides(t) for t in (q, k, v, do)}) == 2  # q, k share one layout; v, dO another
    o, lse = t_train.flash_attention_train_fwd(q, k, v, mask)
    dense = [t.contiguous() for t in (q, k, v, do)]
    o_c, lse_c = t_train.flash_attention_train_fwd(*dense[:3], mask)
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)
    assert o.transpose(1, 2).is_contiguous()  # a view of a (b, n, h, d) buffer
    grads = t_train.flash_attention_train_bwd(q, k, v, o, lse, do, mask)
    grads_c = t_train.flash_attention_train_bwd(*dense[:3], o_c.contiguous(), lse_c, dense[3], mask)
    for got, want in zip(grads, grads_c):
        assert torch.equal(got, want) and got.transpose(1, 2).is_contiguous()
    ref_o, _ = t_train.flash_attention_train_fwd_plain(*(t.float() for t in dense[:3]), mask)
    assert _rel_err(o, ref_o) < (2e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
def test_flash_train_backward_is_deterministic(dev, masked):
    """Two backward calls at the training head shape (16 heads of 64, n
    1024) are bit-equal: each block owns its rows, no atomics."""
    g = torch.Generator().manual_seed(6)
    b, h, n, d = 2, 16, 1024, 64
    q, k, v, do = (torch.randn((b, h, n, d), generator=g).to(dev, torch.bfloat16) for _ in range(4))
    mask = (torch.arange(n)[None] < torch.tensor([[n], [700]])).to(dev) if masked else None
    o, lse = t_train.flash_attention_train_fwd(q, k, v, mask)
    first = t_train.flash_attention_train_bwd(q, k, v, o, lse, do, mask)
    for _ in range(2):
        again = t_train.flash_attention_train_bwd(q, k, v, o, lse, do, mask)
        assert all(torch.equal(a, b_) for a, b_ in zip(first, again))
    assert all(bool(torch.isfinite(t).all()) for t in first)


@pytest.mark.cuda
def test_flash_train_wrapper_raises_on_layouts_the_kernels_do_not_read(dev):
    q, k, v, do, _ = _train_inputs(dev, torch.bfloat16, 128, 64, False)
    odd = torch.zeros((2, 3, 128, 72), device=dev, dtype=torch.bfloat16)[..., 1:65]  # a 2-byte offset start
    before = t_train.flash_attention_train_bwd.launches
    for bad in (q.transpose(2, 3).contiguous().transpose(2, 3), odd, q[:, :1].expand(2, 3, 128, 64)):
        with pytest.raises(ValueError, match="strides"):
            t_train.flash_attention_train_fwd(bad, k, v)
        o, lse = t_train.flash_attention_train_fwd(q, k, v)
        with pytest.raises(ValueError, match="strides"):
            t_train.flash_attention_train_bwd(q, k, v, o, lse, bad)
    assert t_train.flash_attention_train_bwd.launches == before
    # the autograd path copies a gradient it cannot read (here an expanded one) once, then launches
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(t_train.flash_attention_train(*leaves).sum(), leaves)
    assert t_train.flash_attention_train_bwd.launches == before + 2
    assert all(bool(torch.isfinite(t).all()) for t in grads)


@pytest.mark.cuda
def test_flash_train_autograd_and_no_mask(dev):
    q, k, v, do, _ = _train_inputs(dev, torch.bfloat16, 192, 64, False)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = t_train.flash_attention_train(*leaves)
    grads = torch.autograd.grad(o, leaves, do)
    ref_o, ref_lse = t_train.flash_attention_train_fwd_plain(q.float(), k.float(), v.float())
    refs = t_train.flash_attention_train_bwd_plain(q.float(), k.float(), v.float(), ref_o, ref_lse, do.float())
    assert _rel_err(o.detach(), ref_o) < 2e-2
    for got, ref in zip(grads, refs):
        assert _rel_err(got, ref) < 3e-2


@pytest.mark.cuda
def test_conv_pos_train_gradients(dev):
    g = torch.Generator().manual_seed(3)
    x = (torch.randn((2, 96, 1024), generator=g) * 0.5).to(dev, torch.bfloat16).requires_grad_(True)
    ws = [((torch.rand(s, generator=g) - 0.5) * 0.04).to(dev).requires_grad_(True)
          for s in ((31, 64, 1024), (1024,), (31, 64, 1024), (1024,))]
    before = t_conv.conv_pos.launches
    y = t_conv.conv_pos_train(x, *ws)
    assert t_conv.conv_pos.launches == before + 1
    gy = torch.randn(y.shape, generator=g).to(dev, y.dtype)
    grads = torch.autograd.grad(y, [x, *ws], gy)
    ref_in = [t.detach().float().requires_grad_(True) for t in (x, *ws)]
    ref_y = t_conv.conv_pos_plain(*ref_in)
    ref_grads = torch.autograd.grad(ref_y, ref_in, gy.float())
    assert _rel_err(y.detach(), ref_y.detach()) < 3e-2
    for got, ref in zip(grads, ref_grads):
        assert _rel_err(got, ref) < 5e-2


@pytest.mark.cuda
def test_serving_wrappers_raise_on_inputs_that_require_grad(dev):
    q = torch.zeros((1, 2, 64, 64), device=dev, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        t_flash.flash_attention(q, q, q)
    x = torch.zeros((1, 64, 1024), device=dev, dtype=torch.bfloat16, requires_grad=True)
    w = torch.zeros((31, 64, 1024), device=dev, dtype=torch.bfloat16)
    b = torch.zeros((1024,), device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        t_conv.conv_pos(x, w, b, w, b)
    with torch.no_grad():  # inference on the same tensors is allowed
        t_flash.flash_attention(q, q, q)
        t_conv.conv_pos(x, w, b, w, b)


def _decode_case(dev, dtype, b, h, n_kv, total, d, dead_row=None):
    g = torch.Generator().manual_seed(4)
    q = (torch.randn((b, h, 1, d), generator=g) * d**-0.5).to(dev, dtype)
    k, v = (torch.randn((b, n_kv, total, d), generator=g).to(dev, dtype) for _ in range(2))
    allowed = torch.arange(total)[None, :] <= torch.randint(0, total, (b, 1), generator=g)  # a causal bound per row
    allowed[0, :2] = False  # padded prompt keys
    if dead_row is not None:
        allowed[dead_row] = False
    return q, k, v, torch.where(allowed, 0.0, -1e9).to(dev)


# bf16 kernel vs fp32 plain on the same bf16 inputs within 2e-2 (p and o are
# rounded to bf16); fp32 kernel within 1e-5 (summation order only)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("b,h,n_kv,total,d,dead_row", [
    (3, 4, 4, 77, 64, None), (2, 8, 2, 200, 64, 1), (2, 6, 2, 33, 32, None), (1, 16, 2, 300, 128, None),
    (2, 4, 4, 1, 64, None)])
def test_decode_attention_kernel_matches_plain(dev, dtype, tol, b, h, n_kv, total, d, dead_row):
    q, k, v, bias = _decode_case(dev, dtype, b, h, n_kv, total, d, dead_row)
    before = t_dec.decode_attention.launches
    out = t_dec.decode_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert t_dec.decode_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref = t_dec.decode_attention_plain(q.float(), k.float(), v.float(), bias)
    assert float((out.float() - ref).abs().max()) < tol


@pytest.mark.cuda
def test_decode_attention_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    q, k, v, bias = _decode_case(dev, torch.bfloat16, 2, 4, 2, 40, 64)
    with pytest.raises(ValueError, match="head dims"):
        t_dec.decode_attention(q[..., :48].contiguous(), k[..., :48].contiguous(), v[..., :48].contiguous(), bias)
    with pytest.raises(TypeError):
        t_dec.decode_attention(q.half(), k.half(), v.half(), bias)
    with pytest.raises(ValueError, match="multiple of n_kv"):
        t_dec.decode_attention(q[:, :3].contiguous(), k, v, bias)
    with pytest.raises(ValueError, match="contiguous"):
        t_dec.decode_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, bias)
    with pytest.raises(ValueError, match="fp32"):
        t_dec.decode_attention(q, k, v, bias.bfloat16())
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((1, 2, 70000, 64), device=dev, dtype=torch.bfloat16)
        t_dec.decode_attention(q[:1], big, big, torch.zeros((1, 70000), device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        t_dec.decode_attention(q.clone().requires_grad_(True), k, v, bias)
    with torch.no_grad():
        t_dec.decode_attention(q.clone().requires_grad_(True), k, v, bias)


@pytest.mark.cuda
def test_parler_decode_through_the_kernel_matches_the_plain_path(dev):
    """Greedy fp32 decode with ``decode_attn="kernel"`` (every step's self- and
    cross-attention launches the kernel) gives the plain path's codes."""
    from f5tts_tpu_torch.models import parler as TP
    from f5tts_tpu_torch.models.convert import init_parler_decoder_numpy, params_from_numpy

    kw = dict(vocab=40, codebooks=3, hidden=128, layers=2, heads=4, ffn=64, cross_dim=128, prompt_vocab=16,
              kv_heads=2, cross_kv_heads=2)
    params = params_from_numpy(init_parler_decoder_numpy(TP.ParlerDecoderConfig(**kw), seed=0), dev)
    g = torch.Generator().manual_seed(5)
    enc = torch.randn((2, 9, 128), generator=g).to(dev)
    enc_mask = (torch.arange(9)[None] < torch.tensor([[9], [4]])).to(dev)
    prompt = torch.randint(0, 16, (2, 3), generator=g).to(dev)
    outs = {}
    for attn in ("kernel", "plain"):
        before = t_dec.decode_attention.launches
        outs[attn] = TP.parler_generate(params, TP.ParlerDecoderConfig(**kw, decode_attn=attn, fuse_decode_qkv=True),
                                        enc, enc_mask, 6, 0, prompt_ids=prompt, temperature=0.0, eos_token=-1)
        assert t_dec.decode_attention.launches - before == (2 * 2 * (6 + 2) if attn == "kernel" else 0)
    assert torch.equal(outs["kernel"][0], outs["plain"][0]) and torch.equal(outs["kernel"][1], outs["plain"][1])


def _quant_case(dev, dtype, m, k, n):
    g = torch.Generator().manual_seed(6)
    x = torch.randn((m, k), generator=g) * torch.exp(2.0 * torch.randn((m, 1), generator=g))
    x[::17] = 0.0  # all-padding rows
    w_q = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    s_w = torch.rand((n,), generator=g) * 0.01 + 1e-4
    return x.to(dev, dtype), w_q.to(dev), s_w.to(dev)


# bit-equal: exact integer products, and every fp32 step one correctly rounded
# operation in the plain version's order. The first three shapes are the int8
# engine's at the bench geometry (16 x 1024 rows of F5-TTS Base).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(16384, 1024, 1024), (16384, 1024, 2048), (16384, 2048, 1024), (1000, 1024, 1024),
                                   (77, 80, 48), (300, 4096, 64)])
def test_quant_matmul_kernel_is_bit_equal_to_plain(dev, dtype, m, k, n):
    x, w_q, s_w = _quant_case(dev, dtype, m, k, n)
    w_qt = t_quant.kernel_layout(w_q)
    for floors in (dict(amax_floor=1e-6, scale_floor=0.0), dict(amax_floor=0.0, scale_floor=1e-8)):
        before = t_quant.quant_matmul.launches
        out = t_quant.quant_matmul(x, w_q, s_w, w_qt=w_qt, **floors)
        torch.cuda.synchronize()
        assert t_quant.quant_matmul.launches == before + 1
        assert out.shape == (m, n) and out.dtype == dtype
        assert torch.equal(out, t_quant.quant_matmul_plain(x, w_q, s_w, **floors))


@pytest.mark.cuda
def test_quant_matmul_floors_and_the_quantized_linear(dev):
    from f5tts_tpu_torch.models import modules as tm

    x, w_q, s_w = _quant_case(dev, torch.bfloat16, 64, 256, 128)
    x[1] = 1e-7  # abs-max under 1.27e-6: the two floors quantize it differently
    w_qt = t_quant.kernel_layout(w_q)
    a = t_quant.quant_matmul(x, w_q, s_w, w_qt=w_qt)
    b = t_quant.quant_matmul(x, w_q, s_w, w_qt=w_qt, amax_floor=0.0, scale_floor=1e-8)
    assert not torch.equal(a[1], b[1]) and torch.equal(a[2:], b[2:]) and float(a[0].abs().max()) == 0.0
    g = torch.Generator().manual_seed(7)
    p = {"w": (torch.randn((256, 128), generator=g) * 0.05).to(dev, torch.bfloat16),
         "b": torch.randn((128,), generator=g).to(dev, torch.bfloat16)}
    q = tm.quantize_linear_params(p)
    assert set(q) == {"w_q", "s_w", "w_qt", "b"} and q["w_qt"].shape == (128, 256) and q["s_w"].dtype == torch.float32
    before = t_quant.quant_matmul.launches
    y = tm.linear(q, x.reshape(4, 16, 256))
    assert t_quant.quant_matmul.launches == before + 1 and y.shape == (4, 16, 128)
    ref = t_quant.quant_matmul_plain(x, q["w_q"], q["s_w"], amax_floor=0.0, scale_floor=1e-8) + q["b"]
    assert torch.equal(y.reshape(64, 128), ref)


@pytest.mark.cuda
def test_quant_matmul_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    x, w_q, s_w = _quant_case(dev, torch.bfloat16, 32, 64, 32)
    w_qt = t_quant.kernel_layout(w_q)
    with pytest.raises(ValueError, match="w_qt"):
        t_quant.quant_matmul(x, w_q, s_w)  # the kernel layout is made once, not per call
    with pytest.raises(ValueError, match="kernel layout"):
        t_quant.quant_matmul(x, w_q, s_w, w_qt=w_q)
    with pytest.raises(ValueError, match="multiples of 16"):  # a bad K
        t_quant.quant_matmul(x[:, :40].contiguous(), w_q[:40].contiguous(), s_w, w_qt=w_qt[:, :40].contiguous())
    with pytest.raises(ValueError, match="multiples of 16"):  # a bad N
        t_quant.quant_matmul(x, w_q[:, :24].contiguous(), s_w[:24].contiguous(), w_qt=w_qt[:24].contiguous())
    with pytest.raises(TypeError):
        t_quant.quant_matmul(x.half(), w_q, s_w, w_qt=w_qt)
    with pytest.raises(TypeError):
        t_quant.quant_matmul(x, w_q, s_w.bfloat16(), w_qt=w_qt)
    with pytest.raises(ValueError, match="contiguous"):
        t_quant.quant_matmul(x.t().contiguous().t(), w_q, s_w, w_qt=w_qt)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((8192, 16), dtype=torch.int8, device=dev)
        t_quant.quant_matmul(torch.zeros((4, 8192), device=dev), big, s_w[:16].contiguous(),
                             w_qt=t_quant.kernel_layout(big))
    with pytest.raises(ValueError, match="floor"):
        t_quant.quant_matmul(x, w_q, s_w, w_qt=w_qt, amax_floor=0.0, scale_floor=0.0)
    with pytest.raises(RuntimeError, match="no backward"):
        t_quant.quant_matmul(x.clone().requires_grad_(True), w_q, s_w, w_qt=w_qt)
    with torch.no_grad():
        t_quant.quant_matmul(x.clone().requires_grad_(True), w_q, s_w, w_qt=w_qt)


def _ablate_case(dev, bh, n, tail_masked):
    g = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn((bh, n, 64), generator=g).to(dev, torch.bfloat16) for _ in range(3))
    bias = torch.zeros((1, 1, n), device=dev)
    if tail_masked:
        bias[..., 3 * n // 4:] = -1e9  # the last quarter of the keys
    return bias, q, k, v


# each layout against its plain version (fp32 on the same bf16 inputs) and against the unpacked kernel
# (the JAX script's 0.05); the kernel's own count of the mma.sync it issued against the layout's design
@pytest.mark.cuda
@pytest.mark.parametrize("layout", t_abl.LAYOUTS)
@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("bq", [64, 128])
def test_ablate_attention_kernel_matches_plain(dev, layout, n, bq):
    for tail_masked in (False, True):
        bias, q, k, v = _ablate_case(dev, 8, n, tail_masked)
        counted = torch.zeros(1, dtype=torch.int64, device=dev)
        before = t_abl.ablate_attention.launches
        out = t_abl.ablate_attention(layout, bias, q, k, v, bq=bq, mma_count=counted)
        torch.cuda.synchronize()
        assert t_abl.ablate_attention.launches == before + 1
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        assert int(counted) == t_abl.mma_per_call(layout, 8, n)
        ref = t_abl.ablate_attention_plain(layout, bias, q.float(), k.float(), v.float())
        assert float((out.float() - ref).abs().max()) < 2e-2
        unpacked = t_abl.ablate_attention("unpacked", bias, q, k, v, bq=bq)
        assert float((out.float() - unpacked.float()).abs().max()) < 0.05


@pytest.mark.cuda
def test_ablate_attention_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    bias, q, k, v = _ablate_case(dev, 4, 128, False)
    before = t_abl.ablate_attention.launches
    with pytest.raises(ValueError, match="pairs"):  # an odd BH on a pair layout
        t_abl.ablate_attention("packed_blockdiag", bias, q[:3].contiguous(), k[:3].contiguous(), v[:3].contiguous())
    with pytest.raises(ValueError, match="multiple of bq"):
        t_abl.ablate_attention("unpacked", bias[..., :96].contiguous(), *(t[:, :96].contiguous() for t in (q, k, v)))
    with pytest.raises(ValueError, match="head dim"):
        t_abl.ablate_attention("unpacked", bias, *(t[..., :32].contiguous() for t in (q, k, v)))
    with pytest.raises(TypeError):
        t_abl.ablate_attention("unpacked", bias, q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="bq"):
        t_abl.ablate_attention("unpacked", bias, q, k, v, bq=32)
    with pytest.raises(ValueError, match="layout"):
        t_abl.ablate_attention("packed", bias, q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        t_abl.ablate_attention("unpacked", bias, q.clone().requires_grad_(True), k, v)
    assert t_abl.ablate_attention.launches == before


@pytest.mark.cuda
def test_ablate_attention_occupancy_control_changes_nothing_but_occupancy(dev):
    bias, q, k, v = _ablate_case(dev, 8, 256, True)
    smem = t_abl.smem_bytes("packed_blockdiag", 64)
    assert t_abl.smem_bytes("unpacked", 64) < smem <= t_abl.MAX_SMEM
    assert t_abl.blocks_per_sm("unpacked", 64, smem) == t_abl.blocks_per_sm("packed_blockdiag", 64) >= 1
    assert t_abl.blocks_per_sm("unpacked", 64) > t_abl.blocks_per_sm("unpacked", 64, smem)
    out = t_abl.ablate_attention("unpacked", bias, q, k, v, min_smem=smem)
    assert torch.equal(out, t_abl.ablate_attention("unpacked", bias, q, k, v))
    with pytest.raises(ValueError, match="min_smem"):
        t_abl.ablate_attention("unpacked", bias, q, k, v, min_smem=t_abl.MAX_SMEM + 1)
