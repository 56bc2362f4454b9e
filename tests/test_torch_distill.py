"""Step distillation in the port (``f5tts_tpu_torch/train/distill.py``) and the
differentiable conv-pos route it needs, against the JAX package on the CPU at
the micro geometry of ``tests/test_distill.py``. The JAX params are carried
across as numpy; the port's noise is replaced by the JAX noise for the same
seeds (``jax.random`` cannot be reproduced in torch). fp32, JAX matmul
precision ``highest``, TF32 off. Tolerances: loss and gradient norm rtol
1e-4; updated params atol 2e-5 (the bound ``tests/test_distill.py`` holds the
chunked step to; Adam divides each gradient by its own magnitude, so
rounding-level gradients move by up to ~lr/10 apart); the masked training
forward's loss rtol 1e-4 and its gradients within 2e-4 of each leaf's peak
plus 1e-3 relative; the masked conv-pos pair's loss rtol 1e-5 and gradients
atol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.models import dit as jd
from f5tts_tpu.models import modules as jmod
from f5tts_tpu.sampling import euler as je
from f5tts_tpu.train import distill as jdist
from f5tts_tpu_torch.models import dit as td
from f5tts_tpu_torch.models import modules as tmod
from f5tts_tpu_torch.ops.kernels import conv_pos as t_conv
from f5tts_tpu_torch.sampling import euler as te
from f5tts_tpu_torch.train import distill as tdist
from f5tts_tpu_torch.train import trainer as ttrainer
from f5tts_tpu_torch.train.tree import tree_leaves, tree_map

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MICRO = dict(dim=32, depth=1, heads=2, dim_head=16, ff_mult=2, mel_dim=8, text_num_embeds=16, text_dim=16,
             conv_layers=1, max_pos=64)
N, REF = 32, 8
PARAM_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run thousands of tiny torch ops; under a parallel test run
    the CPU is oversubscribed, and an intra-op thread pool that waits at every
    op for descheduled threads makes them ~100x slower. One thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prompts(rng: np.random.Generator, batch=2):
    cond = np.zeros((batch, N, MICRO["mel_dim"]), np.float32)
    cond[:, :REF] = rng.standard_normal((batch, REF, MICRO["mel_dim"])) * 0.5
    return {
        "cond": cond,
        "cond_lens": np.full((batch,), REF, np.int32),
        "text": rng.integers(0, MICRO["text_num_embeds"], (batch, 6)).astype(np.int32),
        "duration": rng.integers(24, N + 1, (batch,)).astype(np.int32),
        "seeds": rng.integers(0, 1 << 30, (batch,)).astype(np.int32),
    }


def _jax_noise(seeds, n, mel_dim, duration, dtype=torch.float32):
    """The JAX sampler's noise for these seeds, as the port's noise function returns it."""
    y0 = je.sample_noise_from_seeds(jnp.asarray(np.asarray(torch.as_tensor(seeds))), n, mel_dim,
                                    jnp.asarray(duration.cpu().numpy()), jnp.float32)
    return torch.as_tensor(np.array(y0)).to(duration.device, dtype)


def _t(tree):
    return tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


@pytest.fixture(scope="module")
def teacher_np():
    return jax.tree.map(np.asarray, jd.init_dit(jax.random.PRNGKey(0), jd.DiTConfig(**MICRO)))


def _tcfg(**kw):
    return td.DiTConfig(**{**MICRO, **kw}, attn_impl="flash", conv_pos_impl="fused")


@pytest.mark.parametrize("steps,sway", [(8, -1.0), (4, None), (16, -0.5)])
def test_time_grid_and_student_sampler_match_jax(steps, sway):
    j = jdist.DistillConfig(student_steps=steps, sway_sampling_coef=sway)
    t = tdist.DistillConfig(student_steps=steps, sway_sampling_coef=sway)
    assert t.time_grid == j.time_grid  # float64 host arithmetic in both: exact
    js, ts = jdist.student_sampler(j), tdist.student_sampler(t)
    for name in ("steps", "cfg_strength", "sway_sampling_coef", "method", "time_grid"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.time_grid[0] == 0.0 and ts.time_grid[-1] == 1.0 and len(ts.time_grid) == steps + 1


def test_deepen_student_matches_jax_bit_for_bit_and_keeps_the_teachers_function(teacher_np):
    cfg = jd.DiTConfig(**{**MICRO, "depth": 2})
    params = jax.tree.map(np.asarray, jd.init_dit(jax.random.PRNGKey(1), cfg))
    # nonzero modulation so the zeroed copies are distinguishable from the kept blocks
    jdeep, jcfg = jdist.deepen_student(jax.tree.map(jnp.asarray, params), cfg, factor=3)
    tdeep, tcfg = tdist.deepen_student(_t(params), _tcfg(depth=2), factor=3)
    assert tcfg.depth == jcfg.depth == 6
    ref = dict(tree_leaves(jax.tree.map(np.asarray, jdeep)))
    got = tree_leaves(tdeep)
    assert [k for k, _ in got] == list(ref)
    for name, leaf in got:
        np.testing.assert_array_equal(leaf.numpy(), ref[name], err_msg=name)
    rng = np.random.default_rng(0)
    x, cond = (torch.as_tensor(rng.standard_normal((2, N, 8)).astype(np.float32)) for _ in range(2))
    text = torch.as_tensor(rng.integers(0, 16, (2, 6)).astype(np.int32))
    args = (x, cond, text, torch.tensor([0.3, 0.7]), torch.zeros(2, dtype=torch.bool), torch.zeros(2, dtype=torch.bool))
    mask = torch.arange(N)[None] < torch.tensor([[N], [27]])
    out_teacher = td.dit_forward(_t(params), _tcfg(depth=2), *args, mask=mask)
    out_deep = td.dit_forward(tdeep, tcfg, *args, mask=mask)
    assert torch.equal(out_teacher, out_deep)  # the inserted blocks pass x through exactly


def _two_steps_jax(teacher_np, kw, batches):
    opt, step = jdist.make_distill_step(jd.DiTConfig(**MICRO), jdist.DistillConfig(**kw))
    step = jax.jit(step)
    teacher = jax.tree.map(jnp.asarray, teacher_np)
    student = jax.tree.map(jnp.copy, teacher)
    state = opt.init(student)
    metrics = []
    for b in batches:
        student, state, m = step(student, state, teacher, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return dict(tree_leaves(jax.tree.map(np.asarray, student))), metrics


def _two_steps_torch(teacher_np, kw, batches):
    optimizer, step = tdist.make_distill_step(_tcfg(), tdist.DistillConfig(**kw))
    teacher = _t(teacher_np)
    student = tdist.copy_params(teacher, "cpu")
    state = optimizer.init(student)
    metrics = []
    for b in batches:
        m = step(student, state, teacher, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    assert state["count"] == len(batches)
    return student, metrics


@pytest.mark.parametrize("single,weighting,chunk,decay", [(False, "adaptive", 2, 5), (True, "none", 0, None)])
def test_distill_step_matches_the_jitted_jax_step(monkeypatch, teacher_np, single, weighting, chunk, decay):
    """Two steps from the same teacher on the same prompts and noise. The two
    cases take each setting both ways: the CFG pair and a single-branch
    teacher, adaptive and uniform knot weighting, the chunked and the
    single-shot loss, the cosine decay and a constant lr."""
    monkeypatch.setattr(tdist, "sample_noise_from_seeds", _jax_noise)
    kw = dict(student_steps=4, substeps=2, learning_rate=3e-4, teacher_single_branch=single,
              knot_weighting=weighting, loss_chunk=chunk, lr_decay_steps=decay)
    rng = np.random.default_rng(3)
    batches = [_prompts(rng) for _ in range(2)]
    ref, jm = _two_steps_jax(teacher_np, kw, batches)
    student, tm = _two_steps_torch(teacher_np, kw, batches)
    for (jl, jg), (tl, tg) in zip(jm, tm):
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_allclose(tg, jg, rtol=1e-4)
    moved = 0
    for name, p in tree_leaves(student):
        np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=PARAM_ATOL, rtol=0, err_msg=name)
        moved += not np.array_equal(p.detach().numpy(), dict(tree_leaves(teacher_np))[name])
    assert moved == len(ref)


def test_loss_chunk_matches_the_single_shot_loss(monkeypatch, teacher_np):
    """Chunked gradient accumulation equals the single-shot loss for uniform
    weighting: the same loss (rtol 1e-5) and update (atol 2e-5)."""
    rng = np.random.default_rng(3)
    batch = _prompts(rng)
    outs = {}
    for kc in (0, 2):
        optimizer, step = tdist.make_distill_step(_tcfg(), tdist.DistillConfig(student_steps=4, substeps=2,
                                                                               loss_chunk=kc))
        teacher = _t(teacher_np)
        student = tdist.copy_params(teacher, "cpu")
        m = step(student, optimizer.init(student), teacher, batch)
        outs[kc] = (float(m["loss"]), student)
    assert np.isclose(outs[0][0], outs[2][0], rtol=1e-5)
    for (name, a), (_, b) in zip(tree_leaves(outs[0][1]), tree_leaves(outs[2][1])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=PARAM_ATOL, err_msg=name)
    with pytest.raises(ValueError, match="must divide"):
        tdist.make_distill_step(_tcfg(), tdist.DistillConfig(student_steps=4, loss_chunk=3))


def test_the_step_halves_run_apart_give_the_step(teacher_np):
    """``step.targets`` then ``step.gradients`` give the whole step's loss and
    gradient norm bit for bit; a bf16 step's ``gradients`` take the fp32
    step's states and targets (finite, no ``.grad`` left set)."""
    batch = _prompts(np.random.default_rng(5))
    teacher = _t(teacher_np)
    dcfg = tdist.DistillConfig(student_steps=4, substeps=2)
    optimizer, step = tdist.make_distill_step(_tcfg(), dcfg)
    student = tdist.copy_params(teacher, "cpu")
    ctx = step.targets(student, teacher, batch)
    assert ctx["states"].shape == ctx["targets"].shape == (4, *batch["cond"].shape)
    loss, grads = step.gradients(student, ctx)
    m = step(tdist.copy_params(teacher, "cpu"), optimizer.init(student), teacher, batch)
    assert float(loss) == float(m["loss"])
    assert float(ttrainer.global_norm(grads)) == float(m["grad_norm"])
    _, bf16_step = tdist.make_distill_step(_tcfg(), dcfg, torch.bfloat16)
    loss16, grads16 = bf16_step.gradients(student, ctx)
    assert np.isfinite(float(loss16)) and all(bool(torch.isfinite(g).all()) for g in grads16)
    assert len(grads16) == len(grads) and all(t.grad is None for _, t in tree_leaves(student))


def test_student_is_a_copy_and_the_teacher_stays_unchanged(teacher_np):
    teacher = _t(teacher_np)
    before = {k: v.clone() for k, v in tree_leaves(teacher)}
    optimizer, step = tdist.make_distill_step(_tcfg(), tdist.DistillConfig(student_steps=2, substeps=1))
    student = tdist.copy_params(teacher, "cpu")
    assert all(s.data_ptr() != t.data_ptr() for (_, s), (_, t) in zip(tree_leaves(student), tree_leaves(teacher)))
    step(student, optimizer.init(student), teacher, _prompts(np.random.default_rng(1)))
    assert all(torch.equal(v, before[k]) for k, v in tree_leaves(teacher))
    assert all(t.grad is None for _, t in tree_leaves(student))


def _err_to_fine(params, sampler, teacher, prompts):
    """mel L2 between a solve under ``sampler``/``params`` and the teacher's
    fine (64-step Euler) guided solve on the same prompts and noise."""
    kw = dict(cond=torch.as_tensor(prompts["cond"]), cond_lens=torch.as_tensor(prompts["cond_lens"]),
              text=torch.as_tensor(prompts["text"]), duration=torch.as_tensor(prompts["duration"]))
    y0 = te.sample_noise_from_seeds(prompts["seeds"], N, MICRO["mel_dim"], kw["duration"])
    cfg = _tcfg()
    fine = te.sample_cfm(teacher, cfg, sampler=te.SamplerConfig(steps=64, cfg_strength=2.0), y0=y0, **kw)
    got = te.sample_cfm(params, cfg, sampler=sampler, y0=y0, **kw)
    d = (fine - got).numpy()
    mask = ((np.arange(N)[None, :] >= prompts["cond_lens"][:, None])
            & (np.arange(N)[None, :] < prompts["duration"][:, None]))
    return float(np.sqrt(np.mean(np.square(d[mask]))))


def test_distilled_student_learns_the_guided_map(teacher_np):
    """The JAX test's claim on the port: after 40 steps on held-out prompts the
    student's K-step unguided rollout is much closer to the teacher's fine
    guided solve than at init."""
    dcfg = tdist.DistillConfig(student_steps=4, substeps=4, learning_rate=3e-4, lr_decay_steps=40, seed=3)
    teacher = _t(teacher_np)
    student = tdist.distill(teacher, _tcfg(), dcfg, _prompts, steps=40, logger=None, device="cpu")
    eval_prompts = _prompts(np.random.default_rng(999))
    err_student = _err_to_fine(student, tdist.student_sampler(dcfg), teacher, eval_prompts)
    err_init = _err_to_fine(teacher, tdist.student_sampler(dcfg), teacher, eval_prompts)
    assert np.isfinite(err_student)
    assert err_student < 0.8 * err_init, (err_student, err_init)


def test_distill_refuses_the_cpu_fallback_without_a_gpu(teacher_np):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.distill(teacher_np, _tcfg(), tdist.DistillConfig(), _prompts, steps=1)


def test_engine_serves_the_student_sampler(teacher_np):
    """A distilled student serves through the engine: Euler on the student
    grid with guidance off, K forwards of b rows (no CFG pair)."""
    from f5tts_tpu.models.vocos import VocosConfig, init_vocos
    from f5tts_tpu_torch.engine.engine import EngineConfig, RowSpec, TTSEngine
    from f5tts_tpu_torch.models.vocos import VocosConfig as TVocosConfig
    from f5tts_tpu_torch.ops.mel import MelConfig
    from f5tts_tpu_torch.text.tokenizer import Tokenizer

    dcfg = tdist.DistillConfig(student_steps=4)
    voc = dict(input_channels=MICRO["mel_dim"], dim=24, intermediate_dim=48, num_layers=1)
    vp = jax.tree.map(np.asarray, init_vocos(jax.random.PRNGKey(1), VocosConfig(**voc)))
    rows_seen = []

    def counting_forward(*a, **kw):
        rows_seen.append(a[2].shape[0])
        return td.dit_forward(*a, **kw)

    eng = TTSEngine(teacher_np, _tcfg(), vp, Tokenizer.from_texts(["student serving test"]), EngineConfig(
        mel=MelConfig(n_mels=MICRO["mel_dim"]), vocoder=TVocosConfig(**voc), sampler=tdist.student_sampler(dcfg),
        duration_buckets=(N,), batch_buckets=(1, 2), text_pad=16, compute_dtype="float32"), device="cpu",
        forward_fn=counting_forward)
    rng = np.random.default_rng(0)
    row = RowSpec(text="student serving test", cond_mel=rng.standard_normal((REF, 8)).astype(np.float32),
                  ref_frames=REF, duration=N - 4, steps=dcfg.student_steps, cfg_strength=0.0, seed=5)
    (wave, mel), = eng.synthesize_rows([row])
    assert np.isfinite(wave).all() and np.isfinite(mel).all()
    assert mel.shape[0] == N - 4 - REF
    assert rows_seen == [1] * dcfg.student_steps


# ---------------------------------------------------------------------------
# the differentiable conv-pos route on masked rows, and the masked training forward
# ---------------------------------------------------------------------------


def _conv_params(rng, c=64, k=31, groups=16):
    cg = c // groups
    return {"conv1": {"w": (rng.standard_normal((k, cg, c)) * 0.1).astype(np.float32),
                      "b": (rng.standard_normal(c) * 0.1).astype(np.float32)},
            "conv2": {"w": (rng.standard_normal((k, cg, c)) * 0.1).astype(np.float32),
                      "b": (rng.standard_normal(c) * 0.1).astype(np.float32)}}


@pytest.mark.parametrize("lens", [(40, 40), (40, 17), (9, 1)])
def test_masked_conv_pos_gradients_match_jax(lens):
    """``conv_pos_embedding(mask, impl="fused")`` with grad on takes
    ``conv_pos_train`` with each row's ``lens``; its gradients in x and the
    four weights equal ``jax.grad`` of the JAX masked formulation (atol 1e-5)."""
    rng = np.random.default_rng(sum(lens))
    p = _conv_params(rng)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    g = rng.standard_normal((2, 40, 64)).astype(np.float32)
    mask = np.arange(40)[None] < np.asarray(lens)[:, None]

    def jloss(p_, x_):
        return jnp.sum(jmod.conv_pos_embedding(p_, x_, jnp.asarray(mask), impl="xla") * g)

    jval, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, p),
                                                                           jnp.asarray(x))
    tp = tree_map(lambda a: torch.as_tensor(a).requires_grad_(True), p)
    tx = torch.as_tensor(x).requires_grad_(True)
    calls = []
    orig = t_conv.ConvPosTrain.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_conv.ConvPosTrain, "apply", lambda *a: calls.append(a[5]) or orig(*a))
        y = tmod.conv_pos_embedding(tp, tx, torch.as_tensor(mask), impl="fused")
    assert len(calls) == 1 and calls[0].tolist() == list(lens)  # the differentiable route, with the lens
    (y * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(float((y * torch.as_tensor(g)).sum().detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5)
    jflat = dict(tree_leaves(jax.tree.map(np.asarray, jgp)))
    for name, t in tree_leaves(tp):
        np.testing.assert_allclose(t.grad.numpy(), jflat[name], atol=1e-5, err_msg=name)
    with torch.no_grad():  # without grad the serving wrapper runs, not the autograd route
        calls.clear()
        tmod.conv_pos_embedding(tp, tx, torch.as_tensor(mask), impl="fused")
    assert calls == []


def test_dit_training_forward_with_a_key_mask_matches_jax_gradients(teacher_np):
    """``dit_forward(training=True, mask=...)`` (the distillation student's
    gradient forward: training attention with the key mask, the masked
    conv-pos route, per-block checkpointing) against ``jax.grad`` of the JAX
    forward with the same mask, on a 2-block DiT."""
    cfg2 = dict(MICRO, depth=2)
    params = jax.tree.map(np.asarray, jd.init_dit(jax.random.PRNGKey(4), jd.DiTConfig(**cfg2)))
    rng = np.random.default_rng(6)
    x, cond, g = (rng.standard_normal((3, N, 8)).astype(np.float32) for _ in range(3))
    text = rng.integers(0, 16, (3, 6)).astype(np.int32)
    time = np.asarray([0.1, 0.5, 0.9], np.float32)
    mask = np.arange(N)[None] < np.asarray([N, 25, 13])[:, None]
    f = np.zeros(3, bool)

    def jloss(p):
        out = jd.dit_forward(p, jd.DiTConfig(**cfg2), jnp.asarray(x), jnp.asarray(cond), jnp.asarray(text),
                             jnp.asarray(time), jnp.asarray(f), jnp.asarray(f), jnp.asarray(mask))
        return jnp.sum(jnp.where(jnp.asarray(mask)[..., None], out, 0.0) * g)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, params))
    tp = tree_map(lambda a: torch.as_tensor(np.array(a)).requires_grad_(True), params)
    tmask = torch.as_tensor(mask)
    out = td.dit_forward(tp, _tcfg(depth=2), torch.as_tensor(x), torch.as_tensor(cond),
                         torch.as_tensor(text), torch.as_tensor(time), torch.as_tensor(f), torch.as_tensor(f),
                         mask=tmask, training=True)
    loss = (torch.where(tmask[..., None], out, 0.0) * torch.as_tensor(g)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jval), rtol=1e-4)
    ref = dict(tree_leaves(jax.tree.map(np.asarray, jgrads)))
    for name, t in tree_leaves(tp):
        r = ref[name]
        got = t.grad.numpy() if t.grad is not None else np.zeros_like(r)
        np.testing.assert_allclose(got, r, atol=2e-4 * max(np.abs(r).max(), 1e-6), rtol=1e-3, err_msg=name)
