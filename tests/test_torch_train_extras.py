"""The training leftovers of the port against the JAX package on the CPU:
Adafactor (``train/trainer.py``) against ``optax.adafactor`` as the JAX
trainer configures it, the CFM loss through the UNetT and MMDiT training
forwards, the sample hook (``train/sample_hook.py``), the logger backends
(``train/metrics.py``), ``FramePackedDataset.from_hf_dataset``, the new
``cli/train.py`` flags and ``utils/{logging,misc}.py``. JAX params carried
across as numpy, fp32, JAX matmul precision ``highest``, TF32 off; each
tolerance is stated at its check."""

import datetime
import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import mmdit as jm
from f5tts_tpu.models import unett as ju
from f5tts_tpu.sampling import euler as je
from f5tts_tpu.train import trainer as jtrainer
from f5tts_tpu_torch.cli import train as t_cli
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import mmdit as tm
from f5tts_tpu_torch.models import unett as tu
from f5tts_tpu_torch.sampling import euler as te
from f5tts_tpu_torch.train import checkpoint as t_ckpt
from f5tts_tpu_torch.train import ema as tema
from f5tts_tpu_torch.train import trainer as ttrainer
from f5tts_tpu_torch.train.tree import tree_leaves, tree_map
from test_torch_cfm import TINY, _flat, batch, jax_draws, jax_params, tiny_configs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

AF_TREE_SHAPES = {"stacked": (3, 200, 130), "thin": (129, 5), "wide": (256, 300), "tie": (2, 128, 128), "vec": (7,)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run thousands of tiny torch ops; under a parallel test run
    the CPU is oversubscribed, and an intra-op thread pool that waits at every
    op for descheduled threads makes them ~100x slower. One thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(tree):
    return tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


def _close_up_to_bf16_flips(got, ref, lr, what):
    """Adafactor's momentum is stored in bf16: both sides round the same
    values, but an fp32 ulp of difference can flip one rounding, which moves
    that element by up to a bf16 ulp of its momentum (2^-8 of an update of a
    few lr). So: every element within 1e-3 of the lr but at most 1 in 10^4,
    and those within 2e-2 of the lr."""
    d = np.abs(got - ref)
    assert np.count_nonzero(d > 1e-3 * lr) <= max(1, d.size // 10_000), (what, np.sort(d.ravel())[-5:])
    np.testing.assert_allclose(got, ref, atol=2e-2 * lr, rtol=0, err_msg=what)


@pytest.mark.parametrize("clip", [1e-2, 1e3])  # the global-norm clip on every update / never
def test_adafactor_matches_optax_over_several_updates(clip):
    """Five updates on factored (a stacked depth axis, two dims >= 128, a tie)
    and unfactored leaves (a thin matrix, a vector), gradients over four
    decades: params within 1e-3 of the lr up to bf16 rounding flips
    (``_close_up_to_bf16_flips``); the state has optax's shapes."""
    kw = dict(learning_rate=1e-2, warmup_updates=2, total_updates=10, grad_clip=clip, weight_decay=0.05,
              optimizer="adafactor")
    rng = np.random.default_rng(0)
    tree = {k: rng.standard_normal(s).astype(np.float32) for k, s in AF_TREE_SHAPES.items()}
    opt = jtrainer.make_optimizer(jtrainer.TrainConfig(**kw))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = opt.init(jparams)
    update = jax.jit(opt.update)
    params, cfg = _t(tree), ttrainer.TrainConfig(**kw)
    state = ttrainer.init_opt_state(params, "adafactor")
    factored = jstate[1][0]
    for k in tree:
        assert tuple(state["v_row"][k].shape) == factored.v_row[k].shape, k
        assert tuple(state["v_col"][k].shape) == factored.v_col[k].shape, k
        assert tuple(state["v"][k].shape) == factored.v[k].shape, k
        assert state["momentum"][k].dtype == torch.bfloat16
    for i in range(5):
        grads = {k: (rng.standard_normal(s) * 10.0 ** (i - 2)).astype(np.float32) for k, s in AF_TREE_SHAPES.items()}
        u, jstate = update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, u)
        ttrainer.optimizer_update(params, [g for _, g in tree_leaves(_t(grads))], state, cfg.optimizer,
                                  ttrainer.lr_schedule(cfg)(state["count"]), cfg.weight_decay, cfg.grad_clip)
        for k in tree:
            _close_up_to_bf16_flips(params[k].numpy(), np.asarray(jparams[k]), kw["learning_rate"], f"update {i} {k}")
    assert state["count"] == 5 and int(jstate[1][0].count) == 5
    for k in tree:  # the moments themselves
        np.testing.assert_allclose(state["v_row"][k].numpy(), np.asarray(jstate[1][0].v_row[k]), rtol=1e-5)
        np.testing.assert_allclose(state["v"][k].numpy(), np.asarray(jstate[1][0].v[k]), rtol=1e-5)
    assert ttrainer.optimizer_state_bytes(state) < ttrainer.optimizer_state_bytes(
        ttrainer.init_opt_state(params, "adamw"))


def test_trainer_with_adafactor_matches_make_train_step_and_resumes(tmp_path):
    """Two Trainer updates with Adafactor (clip, schedule, EMA) against the
    jitted JAX step on the same batches and draws: loss and grad norm rtol
    1e-4, params within 1e-3 of the lr up to bf16 rounding flips (the key
    bias: see below). The state saves and restores (bf16
    momentum, factored moments, count), and a further step from the restored
    state equals one from the live state."""
    jcfg, tcfg = tiny_configs()
    common = dict(learning_rate=1e-3, warmup_updates=1, total_updates=10, grad_clip=0.05, optimizer="adafactor")
    jtcfg = jtrainer.TrainConfig(**common, ema=jtrainer.EMAConfig(update_after_step=0, update_every=1))
    tcfg_train = ttrainer.TrainConfig(**common, ema=tema.EMAConfig(update_after_step=0, update_every=1))
    params = jax_params()
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    jstate = {**jstate, "params": jax.tree.map(jnp.asarray, params), "ema": jax.tree.map(jnp.asarray, params)}
    step = jax.jit(jtrainer.make_train_step(jcfg, jtcfg, compute_dtype=jnp.float32))
    state = ttrainer.init_train_state(tcfg, tcfg_train, "cpu", params_np=params)
    for i, seed in enumerate((4, 8)):
        mel, text, lens = batch(seed)
        key = jax.random.PRNGKey(100 + i)
        jstate, jmet = step(jstate, {"mel": jnp.asarray(mel), "text": jnp.asarray(text), "lens": jnp.asarray(lens),
                                     "key": key})
        tb = {"mel": torch.as_tensor(mel), "text": torch.as_tensor(text), "lens": torch.as_tensor(lens)}
        tmet = ttrainer.train_step(state, tb, [jax_draws(key, 2, 96, TINY["mel_dim"], jcfg)], tcfg, tcfg_train,
                                   torch.float32)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
    ref = _flat(jstate["params"])
    lr = common["learning_rate"]
    for name, p in tree_leaves(state["params"]):
        got = p.detach().numpy()
        if name.endswith("to_k/b"):
            # the key bias's gradient is zero up to rounding (the softmax ignores a per-row shift of the
            # scores) and Adafactor has no eps to damp it: both updates are rounding noise scaled to ~lr,
            # so the leaf is held to the move two updates can make
            np.testing.assert_allclose(got, ref[name], atol=4 * lr, rtol=0, err_msg=name)
        else:
            _close_up_to_bf16_flips(got, ref[name], lr, name)

    t_ckpt.save_state(str(tmp_path), 2, state)
    restored = t_ckpt.restore_state(str(tmp_path), 2)
    assert restored["opt_state"]["count"] == 2
    for (name, a), (_, b) in zip(tree_leaves(state["opt_state"]), tree_leaves(restored["opt_state"])):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    restored["params"] = tree_map(lambda t: t.requires_grad_(True), restored["params"])
    mel, text, lens = batch(9)
    tb = {"mel": torch.as_tensor(mel), "text": torch.as_tensor(text), "lens": torch.as_tensor(lens)}
    draws = [jax_draws(jax.random.PRNGKey(7), 2, 96, TINY["mel_dim"], jcfg)]
    m1 = ttrainer.train_step(state, tb, draws, tcfg, tcfg_train, torch.float32)
    m2 = ttrainer.train_step(restored, tb, draws, tcfg, tcfg_train, torch.float32)
    assert float(m1["loss"]) == float(m2["loss"])
    for (name, a), (_, b) in zip(tree_leaves(state["params"]), tree_leaves(restored["params"])):
        assert torch.equal(a.detach(), b.detach()), name


UNETT = dict(dim=64, depth=4, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_num_embeds=40, text_dim=32,
             conv_layers=1, max_pos=256)
MMDIT = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_num_embeds=40)


def _backbone(kind: str):
    if kind == "unett":
        params = jax.tree.map(np.asarray, ju.init_unett(jax.random.PRNGKey(3), ju.UNetTConfig(**UNETT)))
        return ju.UNetTConfig(**UNETT), tu.UNetTConfig(**UNETT), params
    params = jax.tree.map(np.asarray, jm.init_mmdit(jax.random.PRNGKey(3), jm.MMDiTConfig(**MMDIT)))
    return jm.MMDiTConfig(**MMDIT), tm.MMDiTConfig(**MMDIT), params


@pytest.mark.parametrize("kind", ["unett", "mmdit"])
def test_cfm_loss_through_the_other_backbones_matches_jax(kind):
    """``cfm_loss`` with the backbone picked from the config (``backbone_fns``)
    runs ``unett_forward`` / ``mmdit_forward`` in training mode (differentiable
    kernels, checkpointed blocks): loss rtol 1e-5, each gradient leaf within
    2e-4 of its own peak plus 1e-3 relative, against ``jax.grad`` of the JAX
    ``cfm_loss`` with the same draws."""
    jmodel, tmodel, params = _backbone(kind)
    jcfg, tcfg = jcfm.CFMConfig(model=jmodel), tcfm.CFMConfig(model=tmodel)
    mel, text, lens = batch(6)
    key = jax.random.PRNGKey(31)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jcfm.cfm_loss(p, jcfg, key, jnp.asarray(mel), jnp.asarray(text), jnp.asarray(lens)),
        has_aux=True))(jax.tree.map(jnp.asarray, params))
    tparams = tree_map(lambda a: torch.as_tensor(np.array(a)).requires_grad_(True), params)
    loss, _ = tcfm.cfm_loss(tparams, tcfg, jax_draws(key, 2, 96, 20, jcfg), torch.as_tensor(mel),
                            torch.as_tensor(text), torch.as_tensor(lens))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    ref = _flat(jgrads)
    for name, t in tree_leaves(tparams):
        g = t.grad.numpy() if t.grad is not None else np.zeros_like(ref[name])
        np.testing.assert_allclose(g, ref[name], atol=2e-4 * float(np.abs(ref[name]).max()) + 1e-9, rtol=1e-3,
                                   err_msg=name)


def test_trainer_trains_the_unett_from_its_numpy_init():
    """``init_train_state`` takes the backbone's own seeded init; a Trainer
    step on the UNetT moves every leaf."""
    _, tmodel, _ = _backbone("unett")
    cfg = ttrainer.TrainConfig(learning_rate=1e-3, warmup_updates=1, total_updates=10)
    trainer = ttrainer.Trainer(tcfm.CFMConfig(model=tmodel), cfg, compute_dtype=torch.float32, device="cpu")
    state, _ = trainer.init_or_resume()
    assert "first_half" in state["params"]
    before = {k: v.detach().clone() for k, v in tree_leaves(state["params"])}
    mel, text, lens = batch(2)
    for _ in range(2):  # the first update runs at schedule(0) = 0
        metrics = trainer.step(state, {"mel": mel, "text": text, "lens": lens})
    assert np.isfinite(float(metrics["loss"]))
    assert all(not torch.equal(before[k], v.detach()) for k, v in tree_leaves(state["params"]))


def _jax_noise(seeds, n, mel_dim, duration, dtype=torch.float32):
    y0 = je.sample_noise_from_seeds(jnp.asarray(np.asarray(seeds)), n, mel_dim, jnp.asarray(duration.numpy()),
                                    jnp.float32)
    return torch.as_tensor(np.array(y0)).to(dtype)


def test_sample_hook_matches_the_jax_hook(tmp_path, monkeypatch):
    """The same prompts, weights and noise through both hooks: the generated
    mels within atol 1e-4 (an NFE-4 Euler solve of a 2-block DiT), the same
    files and metric names, the EMA weights by default, and wavs with a
    vocoder."""
    from f5tts_tpu.models.vocos import VocosConfig, init_vocos
    from f5tts_tpu.train.sample_hook import make_sample_hook as j_hook
    from f5tts_tpu_torch.models.vocos import VocosConfig as TVocosConfig
    from f5tts_tpu_torch.train.data import synthetic_batches
    from f5tts_tpu_torch.train.sample_hook import make_sample_hook, prompts_from_batch

    monkeypatch.setattr(te, "sample_noise_from_seeds", _jax_noise)
    jcfg, tcfg = tiny_configs()
    b0 = next(synthetic_batches(tcfg.model, frames=48, batch=3, n_batches=1, seed=1))
    b0["lens"] = np.array([48, 37, 5], np.int32)  # a row under 8 frames is skipped
    prompts = prompts_from_batch(b0, k=3)
    assert len(prompts) == 2
    params = jax_params()
    j_logged, t_logged = [], []
    jh = j_hook(jcfg, str(tmp_path / "j"), prompts, nfe_step=4, logger=lambda **kw: j_logged.append(kw))
    jm_ = jh({"ema": jax.tree.map(jnp.asarray, params)}, 5)
    voc = dict(input_channels=20, dim=16, intermediate_dim=32, num_layers=1)
    vp = jax.tree.map(np.asarray, init_vocos(jax.random.PRNGKey(3), VocosConfig(**voc)))
    th = make_sample_hook(tcfg, str(tmp_path / "t"), prompts, nfe_step=4, vocoder=(vp, TVocosConfig(**voc)),
                          logger=lambda **kw: t_logged.append(kw))
    zeros = tree_map(torch.zeros_like, _t(params))  # the live params must not be what is sampled
    tm_ = th({"ema": _t(params), "params": zeros}, 5)
    assert tm_.keys() == jm_.keys() == {"sample_mel_rms_p0", "sample_mel_rms_p1"}
    for i in range(2):
        got, ref = np.load(tmp_path / "t" / f"step5_p{i}.npy"), np.load(tmp_path / "j" / f"step5_p{i}.npy")
        assert got.shape == ref.shape == (prompts[i]["duration"] - len(prompts[i]["cond_mel"]), 20)
        np.testing.assert_allclose(got, ref, atol=1e-4)
        np.testing.assert_allclose(tm_[f"sample_mel_rms_p{i}"], jm_[f"sample_mel_rms_p{i}"], rtol=1e-4)
        assert (tmp_path / "t" / f"step5_p{i}.wav").stat().st_size > 44
    assert [m["step"] for m in t_logged] == [5]


def test_trainer_fires_the_sample_hook_at_its_cadence():
    fired = []
    _, tcfg = tiny_configs()
    trainer = ttrainer.Trainer(tcfg, ttrainer.TrainConfig(), compute_dtype=torch.float32, device="cpu",
                               save_every=3, sample_hook=lambda state, step: fired.append(step), sample_every=2)
    state, _ = trainer.init_or_resume()
    mel, text, lens = batch(1)
    trainer.fit(state, [{"mel": mel, "text": text, "lens": lens}] * 4)
    assert fired == [2, 4]
    trainer.sample_every, fired[:] = None, []  # None: the checkpoint cadence
    trainer.fit(state, [{"mel": mel, "text": text, "lens": lens}] * 2)
    assert fired == [6]


def test_make_logger_backends(tmp_path, capsys):
    from f5tts_tpu.train import metrics as jmetrics
    from f5tts_tpu_torch.train.metrics import JsonlLogger, make_logger

    log = make_logger("jsonl", "run", str(tmp_path))
    log(step=1, loss=0.5)
    log.close()
    rec = json.loads((tmp_path / "run.jsonl").read_text())
    assert rec["step"] == 1 and rec["loss"] == 0.5 and "ts" in rec
    assert json.loads(capsys.readouterr().out)["loss"] == 0.5
    os.makedirs(tmp_path / "j", exist_ok=True)
    ref = jmetrics.make_logger("jsonl", "run", str(tmp_path / "j"))  # the JAX logger writes the same keys
    ref(step=1, loss=0.5)
    ref.close()
    assert json.loads((tmp_path / "j" / "run.jsonl").read_text()).keys() == rec.keys()
    capsys.readouterr()

    out = make_logger("stdout", "run", str(tmp_path / "none"))
    assert isinstance(out, JsonlLogger) and out.path is None
    out(step=2, grad_norm=1.5)
    assert json.loads(capsys.readouterr().out)["grad_norm"] == 1.5
    assert not (tmp_path / "none").exists()

    tb = make_logger("tensorboard", "tb", str(tmp_path))
    tb(step=3, loss=0.25, note="text is skipped")
    tb(step=4, loss=0.125)
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    tb.close()
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert acc.Tags()["scalars"] == ["loss"]
    assert [(e.step, e.value) for e in acc.Scalars("loss")] == [(3, 0.25), (4, 0.125)]

    wb = make_logger("wandb", "wb", str(tmp_path))  # wandb is not installed: the JAX message, then JSONL
    assert "wandb unavailable; falling back to jsonl" in capsys.readouterr().out
    assert isinstance(wb, JsonlLogger) and wb.path == f"{tmp_path}/wb.jsonl"
    wb.close()


def test_from_hf_dataset_matches_jax():
    """An in-memory ``datasets.Dataset`` (no hub access): the same items,
    filter, tokenizer and packing as the JAX loader, and log-mels within the
    tolerance of ``test_torch_ops.test_bucketed_log_mel`` (atol 1e-4, rtol
    1e-5)."""
    import datasets

    from f5tts_tpu.train.data import FramePackedDataset as JDataset
    from f5tts_tpu_torch.train.data import FramePackedDataset

    rng = np.random.default_rng(0)
    lens = (24000, 12000, 2000, 30000, 16000)  # the 2000-sample row is under 0.3 s: filtered out
    ds_hf = datasets.Dataset.from_dict({
        "text": [f"sample number {i}" for i in range(len(lens))],
        "audio": [{"array": (rng.standard_normal(n) * 0.1).astype(np.float32), "sampling_rate": 24000}
                  for n in lens]})
    got, ref = FramePackedDataset.from_hf_dataset(ds_hf), JDataset.from_hf_dataset(ds_hf)
    assert [(i.text, i.n_frames, i.hf_index) for i in got.items] == [(i.text, i.n_frames, i.hf_index)
                                                                      for i in ref.items]
    assert len(got.items) == 4 and got.tokenizer.vocab_size == ref.tokenizer.vocab_size
    gb = list(got.batches(batch_frames=200, max_samples=2, frame_bucket=32, epochs=1))
    rb = list(ref.batches(batch_frames=200, max_samples=2, frame_bucket=32, epochs=1))
    assert len(gb) == len(rb) > 1
    for g, r in zip(gb, rb):
        np.testing.assert_array_equal(g["lens"], r["lens"])
        np.testing.assert_array_equal(g["text"], r["text"])
        np.testing.assert_allclose(g["mel"], r["mel"], atol=1e-4, rtol=1e-5)


def test_train_cli_smoke_with_adafactor_and_the_sample_hook(tmp_path, capsys):
    state = t_cli.main(["--smoke", "--device", "cpu", "--optimizer", "adafactor", "--sample-every", "1",
                        "--sample-nfe", "2", "--checkpoint-dir", str(tmp_path / "ck")])
    assert state["step"] == 3 and "momentum" in state["opt_state"] and state["opt_state"]["count"] == 3
    files = sorted(p.name for p in (tmp_path / "ck" / "samples").iterdir())
    assert files == [f"step{s}_p{i}.npy" for s in (1, 2, 3) for i in (0, 1)]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert sum("sample_mel_rms_p0" in x for x in lines) == 3 and sum("loss" in x for x in lines) == 3


@pytest.mark.parametrize("name", ["E2TTS_Base", "E2TTS_Small", "F5TTS_Small"])
def test_train_cli_model_names_resolve_as_the_jax_cli(name):
    from f5tts_tpu.cli import train as j_cli

    vocab = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "vocab.txt")
    got, ref = t_cli.resolve_model_cfg(name, vocab).model, j_cli.resolve_model_cfg(name, vocab).model
    assert type(got).__name__ == type(ref).__name__
    for field in ("dim", "depth", "heads", "dim_head", "ff_mult", "mel_dim", "text_num_embeds", "text_dim",
                  "conv_layers"):
        assert getattr(got, field) == getattr(ref, field), field
    assert name in t_cli.MODEL_NAMES and tuple(t_cli.MODEL_NAMES) == tuple(j_cli.MODEL_NAMES)


@pytest.mark.parametrize("optim,want", [("bnb_optimizer: true", "adafactor"), ("bnb_optimizer: false", "adamw"),
                                        ("optimizer: adafactor", "adafactor")])
def test_train_config_yaml_maps_bnb_optimizer_to_adafactor(tmp_path, optim, want):
    path = tmp_path / "cfg.yaml"
    path.write_text(f"model:\n  name: E2TTS_Small\noptim:\n  learning_rate: 1.0e-4\n  {optim}\n")
    p = t_cli.build_argparser()
    args = p.parse_args(["--train-config", str(path)])
    t_cli.apply_train_config(p, args)
    assert (args.optimizer, args.model, args.learning_rate) == (want, "E2TTS_Small", 1e-4)


def test_utils_logging_and_misc(tmp_path):
    from f5tts_tpu.utils import misc as jmisc
    from f5tts_tpu_torch.audio.io import write_wav
    from f5tts_tpu_torch.utils import logging as tlogging
    from f5tts_tpu_torch.utils import misc as tmisc

    ist = datetime.timezone(datetime.timedelta(hours=5, minutes=30))
    for h, mnt in ((0, 0), (9, 5), (13, 30), (23, 59), (12, 0)):
        now = datetime.datetime(2026, 1, 2, h, mnt, tzinfo=ist)
        assert tmisc.time_to_words(now) == jmisc.time_to_words(now)
    path = tmp_path / "v.wav"
    write_wav(str(path), np.zeros(2400, np.float32), 24000)
    for src in (str(path), f"file://{path}"):
        wave, sr = tmisc.load_audio(src)
        assert sr == 24000 and wave.shape == (2400,)
    with pytest.raises(ValueError, match="remote voice URLs"):
        tmisc.load_audio("https://example.invalid/v.wav")
    with pytest.raises(FileNotFoundError):
        tmisc.load_audio(str(tmp_path / "missing.wav"))
    assert tmisc.describe_device("cpu") == {"platform": "cpu", "devices": 1, "kind": "cpu"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmisc.describe_device()
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    try:
        logger = tlogging.setup_logging(str(tmp_path / "f5.log"), level="DEBUG")
        logger.debug("hello")
        assert logger.name == "f5tpu" and root.level == logging.DEBUG
        assert {type(h).__name__ for h in root.handlers} >= {"StreamHandler", "RotatingFileHandler"}
        for h in root.handlers:
            h.flush()
        assert "hello" in (tmp_path / "f5.log").read_text()
    finally:
        for h in root.handlers:
            if h not in saved[0]:
                h.close()
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])
