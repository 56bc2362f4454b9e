"""The backbones' row norms (``ops/kernels/row_norm.py``, ``csrc/row_norm.cu``)
and their call sites (``models/modules.py:modulated_layer_norm``,
``rms_norm``).

On the CPU: the kernel's plain version against today's chain (bit for bit in
fp32) and against the JAX package's ``layer_norm`` + modulation and
``rms_norm`` in bf16; the helpers keep the chain, and its gradients, where a
gradient is carried; the wrapper's checks refuse what the kernel does not
take. Marked ``cuda`` (skip here): the kernel against its plain version at the
main-path shapes and at odd row counts, and the launches of one serving
forward of F5-TTS Base and of the E2-TTS UNetT Base. JAX is imported inside
the tests that use it, so the card runs this file without it:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_row_norm.py
"""

import numpy as np
import pytest
import torch

from f5tts_tpu_torch.models import modules as tmod
from f5tts_tpu_torch.ops.kernels import row_norm as t_rn

# bf16: JAX rounds the norm, ``1 + scale``, the product and the sum to bf16 one after another, the plain version
# once; four roundings of half a bf16 ulp (2^-9 of the value) each apart at most, on the largest term
BF16_REL = 4 * 2.0**-9


def _modulated_inputs(b, n, c, dtype, seed=0, chunks=6):
    """``x (b, n, c)`` and ``scale``, ``shift``: strided chunks of one ``(b, chunks * c)`` projection, as
    ``adaln_zero`` (6) and ``adaln_zero_final`` (2) take them."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((b, n, c), generator=g) * 3 + 0.5).to(dtype)
    mod = (torch.randn((b, chunks * c), generator=g) * 0.5).to(dtype)
    parts = mod.chunk(chunks, dim=-1)
    return x, parts[1], parts[0]  # scale_msa, shift_msa in adaln_zero's order


def _rms_inputs(b, n, c, dtype, g_dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((b, n, c), generator=gen) * 2).to(dtype)
    x[0, 0] = 0  # a zero row meets the eps floor
    return x, (1 + 0.3 * torch.randn((c,), generator=gen)).to(g_dtype)


def _todays_modulation(x, scale, shift):
    return tmod.layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


@pytest.fixture
def jax_modules():
    import jax.numpy as jnp

    from f5tts_tpu.models import modules as jmod

    return jnp, jmod


# ---------------------------------------------------------------------------
# the plain version and the helpers on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunks", [6, 2])
@pytest.mark.parametrize("shape", [(3, 37, 64), (2, 1, 1024), (1, 5, 8)])
def test_plain_modulated_equals_todays_chain_in_fp32(shape, chunks):
    x, scale, shift = _modulated_inputs(*shape, torch.float32, chunks=chunks)
    assert scale.stride(0) == chunks * shape[-1]  # a chunk of the projection, read through its row stride
    want = _todays_modulation(x, scale, shift)
    assert torch.equal(t_rn.row_norm_plain(x, scale=scale, shift=shift, eps=1e-6), want)
    assert torch.equal(t_rn.row_norm(x, scale=scale, shift=shift, eps=1e-6), want)  # CPU: the plain version
    assert torch.equal(tmod.modulated_layer_norm(x, scale, shift), want)


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 16), (3, 41, 1024)])
def test_plain_rms_equals_todays_chain_in_fp32(shape, g_dtype):
    x, g = _rms_inputs(*shape, torch.float32, g_dtype)
    x32 = x.float()
    want = x32 * torch.rsqrt(torch.clamp_min((x32 * x32).sum(-1, keepdim=True), 1e-8)) * (x.shape[-1] ** 0.5)
    want = want * g.float()
    assert torch.equal(t_rn.row_norm_plain(x, g=g, eps=1e-8), want)
    assert torch.equal(tmod.rms_norm({"g": g}, x), want)


def test_helpers_keep_the_chain_on_the_cpu_in_bf16():
    """The CPU path rounds as the JAX package does (norm, then each step of the modulation)."""
    x, scale, shift = _modulated_inputs(4, 33, 256, torch.bfloat16, seed=3)
    assert torch.equal(tmod.modulated_layer_norm(x, scale, shift), _todays_modulation(x, scale, shift))
    xr, g = _rms_inputs(4, 33, 256, torch.bfloat16, torch.float32, seed=4)
    x32 = xr.float()
    want = (x32 * torch.rsqrt(torch.clamp_min((x32 * x32).sum(-1, keepdim=True), 1e-8)) * 16.0 * g).to(xr.dtype)
    assert torch.equal(tmod.rms_norm({"g": g}, xr), want)


@pytest.mark.parametrize("chunks", [6, 2])
def test_plain_modulated_matches_jax_in_bf16(jax_modules, chunks):
    jnp, jmod = jax_modules
    x, scale, shift = _modulated_inputs(4, 50, 1024, torch.bfloat16, seed=7, chunks=chunks)
    got = t_rn.row_norm_plain(x, scale=scale, shift=shift, eps=1e-6).float().numpy()
    xj, sj, hj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (x, scale, shift))
    ref = np.asarray((jmod.layer_norm(xj) * (1 + sj[:, None]) + hj[:, None]).astype(jnp.float32))
    err = np.abs(got - ref).max()
    assert err <= BF16_REL * np.abs(ref).max(), (err, np.abs(ref).max())
    assert np.mean(got == ref) > 0.5  # most elements round to the same bf16


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_plain_rms_matches_jax_in_bf16(jax_modules, g_dtype):
    jnp, jmod = jax_modules
    x, g = _rms_inputs(4, 50, 1024, torch.bfloat16, g_dtype, seed=8)
    got = t_rn.row_norm_plain(x, g=g, eps=1e-8).float().numpy()
    gj = jnp.asarray(g.float().numpy()).astype(jnp.bfloat16 if g_dtype == torch.bfloat16 else jnp.float32)
    ref = np.asarray(jmod.rms_norm({"g": gj}, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
                     .astype(jnp.float32))
    # one rounding in both, of fp32 chains whose rsqrt may differ in the last bit: at most one bf16 ulp apart
    err = np.abs(got - ref)
    assert (err <= np.abs(ref) * 2.0**-7).all() and np.mean(err == 0) > 0.99, err.max()


def test_helpers_take_the_chain_and_its_gradients_with_grad_on():
    launches = t_rn.row_norm.launches
    x, scale, shift = _modulated_inputs(2, 9, 64, torch.float32, seed=5)
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, shift)]
    assert tmod._carries_grad(*leaves)
    assert not tmod._carries_grad(x, scale, shift)
    with torch.no_grad():
        assert not tmod._carries_grad(*leaves)
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(6))
    got = torch.autograd.grad(tmod.modulated_layer_norm(*leaves), leaves, cot)
    want = torch.autograd.grad(_todays_modulation(*leaves), leaves, cot)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    xr, g = _rms_inputs(2, 9, 64, torch.float32, torch.float32, seed=7)
    xr, g = xr.requires_grad_(True), g.requires_grad_(True)
    got = torch.autograd.grad(tmod.rms_norm({"g": g}, xr), (xr, g), cot)
    x32 = xr.float()
    chain = x32 * torch.rsqrt(torch.clamp_min((x32 * x32).sum(-1, keepdim=True), 1e-8)) * 8.0 * g
    want = torch.autograd.grad(chain, (xr, g), cot)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert t_rn.row_norm.launches == launches  # nothing here reaches the kernel


def test_checks_refuse_what_the_kernel_does_not_take():
    x, scale, shift = _modulated_inputs(2, 6, 64, torch.bfloat16)
    assert t_rn.check_inputs(x, scale=scale, shift=shift) == "modulated"
    assert t_rn.check_inputs(x, g=torch.ones(64)) == "rms"
    bad = [
        (dict(x=x.transpose(0, 1), scale=scale, shift=shift), "contiguous"),
        (dict(x=x[..., :60].contiguous(), scale=scale[:, :60], shift=shift[:, :60]), "width"),
        (dict(x=torch.zeros((2, 3, 4104), dtype=torch.bfloat16), g=torch.ones(4104)), "width"),
        (dict(x=torch.zeros((2, 3, 2056)), g=torch.ones(2056)), "width"),
        (dict(x=x.half(), g=torch.ones(64)), "contiguous bf16/fp32"),
        (dict(x=x, scale=scale.to("meta"), shift=shift), "every input must be on"),
        (dict(x=x, g=torch.ones(64, device="meta")), "every input must be on"),
        (dict(x=x, scale=scale.float(), shift=shift), "must be torch.bfloat16"),
        (dict(x=x, scale=scale[:1], shift=shift[:1]), "must be (2, 64)"),
        (dict(x=x[0], scale=scale, shift=shift), "must be (6, 64)"),
        (dict(x=x, g=torch.ones(32)), "g must be"),
        (dict(x=x, scale=scale), "takes scale and shift"),
        (dict(x=x, scale=scale, shift=shift, g=torch.ones(64)), "takes scale and shift"),
        (dict(x=x, scale=scale.new_zeros((2, 6 * 64 + 1))[:, 1:65], shift=shift), "aligned to 8"),
        (dict(x=x, scale=scale.new_zeros((2, 128))[:, ::2], shift=shift), "unit-strided"),
        (dict(x=x, g=torch.ones(65)[1:]), "aligned to 8"),
    ]
    for kw, what in bad:
        with pytest.raises(ValueError, match=what.replace("(", r"\(").replace(")", r"\)")):
            t_rn.check_inputs(**kw)
    with pytest.raises(ValueError, match="runs on cuda"):
        t_rn.row_norm(torch.zeros((2, 3, 64), device="meta"), g=torch.ones(64, device="meta"), eps=1e-8)


def test_max_width_covers_the_ports_models():
    from f5tts_tpu_torch.models.ar import ARConfig
    from f5tts_tpu_torch.models.dit import DiTConfig
    from f5tts_tpu_torch.models.mmdit import MMDiTConfig
    from f5tts_tpu_torch.models.unett import UNetTConfig

    widths = {DiTConfig.base().dim, DiTConfig.small().dim, UNetTConfig.base().dim, UNetTConfig.small().dim,
              MMDiTConfig().dim, ARConfig().dim}
    assert t_rn.max_width(torch.bfloat16) == 4096 and t_rn.max_width(torch.float32) == 2048
    assert all(c % 8 == 0 and c <= t_rn.max_width(torch.float32) for c in widths), widths


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the row-norm kernel has no CPU mode")
    return torch.device("cuda")


def _assert_close(out, ref):
    """fp32: the sums' order apart. bf16: both round one fp32 value, and the two values differ only by the
    order of the sums, so they land at most one bf16 ulp (2^-7 of the value) apart."""
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        return
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    assert bool((err <= ref.abs() * 2.0**-7 + 1e-5).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,c,chunks", [(16, 1024, 1024, 6), (16, 1024, 1024, 2), (3, 7, 1024, 6), (1, 1, 768, 2),
                                          (5, 333, 512, 6), (2, 3, 8, 6), (2, 5, 2048, 2)])
def test_modulated_kernel_matches_plain(dev, dtype, b, n, c, chunks):
    x, scale, shift = (t.to(dev) for t in _modulated_inputs(b, n, c, dtype, seed=b + n + c, chunks=chunks))
    before = t_rn.row_norm.launches
    out = t_rn.row_norm(x, scale=scale, shift=shift, eps=1e-6)
    assert t_rn.row_norm.launches == before + 1
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == x.shape
    _assert_close(out, t_rn.row_norm_plain(x, scale=scale, shift=shift, eps=1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,g_dtype", [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                                           (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("b,n,c", [(16, 1025, 1024), (3, 7, 1024), (8, 1, 512), (1, 13, 4096), (2, 3, 8)])
def test_rms_kernel_matches_plain(dev, dtype, g_dtype, b, n, c):
    if c > t_rn.max_width(dtype):
        pytest.skip(f"{c} is wider than the kernel takes in {dtype}")
    x, g = (t.to(dev) for t in _rms_inputs(b, n, c, dtype, g_dtype, seed=b + n + c))
    before = t_rn.row_norm.launches
    out = t_rn.row_norm(x, g=g, eps=1e-8)
    assert t_rn.row_norm.launches == before + 1
    torch.cuda.synchronize()
    _assert_close(out, t_rn.row_norm_plain(x, g=g, eps=1e-8))


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ["dit", "unett"])
def test_one_serving_forward_launches_two_a_block_and_the_final_norm(dev, backbone):
    """2 x depth + 1 launches a bf16 forward under ``no_grad`` (45 in F5-TTS Base, 49 in the UNetT Base), none
    with a gradient to carry (the training forward, every norm on the chain)."""
    from f5tts_tpu_torch.models import convert
    from f5tts_tpu_torch.models.dit import DiTConfig, dit_forward
    from f5tts_tpu_torch.models.unett import UNetTConfig, unett_forward

    if backbone == "dit":
        cfg, forward = DiTConfig.base(), dit_forward
        params = convert.dit_params_from_numpy(convert.init_dit_numpy(cfg, seed=0), dev, torch.bfloat16)
    else:
        cfg, forward = UNetTConfig.base(), unett_forward
        params = convert.unett_params_from_numpy(convert.init_unett_numpy(cfg, seed=0), dev, torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    b, n = 2, 96
    x = torch.randn((b, n, cfg.mel_dim), generator=g).to(dev)
    cond = torch.randn((b, n, cfg.mel_dim), generator=g).to(dev)
    text = torch.randint(0, 50, (b, 24), generator=g).to(dev, torch.int32)
    time = torch.tensor([0.3, 0.7], device=dev)
    drop = torch.tensor([False, True], device=dev)
    want = {"dit": 45, "unett": 49}[backbone]
    assert 2 * cfg.depth + 1 == want
    before = t_rn.row_norm.launches
    with torch.no_grad():
        out = forward(params, cfg, x, cond, text, time, drop, drop, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert t_rn.row_norm.launches - before == want and bool(torch.isfinite(out).all())

    before = t_rn.row_norm.launches
    xg = x.clone().requires_grad_(True)
    out = forward(params, cfg, xg, cond, text, time, drop, drop, compute_dtype=torch.bfloat16, training=True)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert t_rn.row_norm.launches == before and xg.grad is not None and bool(torch.isfinite(xg.grad).all())
