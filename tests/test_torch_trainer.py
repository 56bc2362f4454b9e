"""The port's trainer (``f5tts_tpu_torch/train``, ``cli/train.py``) against the
JAX package on the CPU: the optimizer (optax's AdamW, clip and schedule
semantics), two full train steps against ``make_train_step``, gradient
accumulation, the EMA, the batching, checkpoints and the CLI. Draws come from
the JAX key split (``test_torch_cfm.jax_draws``). fp32, JAX matmul precision
``highest``, TF32 off; tolerances are stated at each check."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from f5tts_tpu.models import convert as j_convert
from f5tts_tpu.models import dit as jd
from f5tts_tpu.train import data as jdata
from f5tts_tpu.train import ema as jema
from f5tts_tpu.train import trainer as jtrainer
from f5tts_tpu_torch.cli import train as t_cli
from f5tts_tpu_torch.models import convert as t_convert
from f5tts_tpu_torch.models import dit as td
from f5tts_tpu_torch.train import checkpoint as t_ckpt
from f5tts_tpu_torch.train import data as tdata
from f5tts_tpu_torch.train import ema as tema
from f5tts_tpu_torch.train import trainer as ttrainer
from f5tts_tpu_torch.train.tree import tree_leaves
from test_torch_cfm import TINY, _flat, batch, jax_draws, jax_params, tiny_configs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


def test_lr_schedule_matches_optax_counts():
    cfg = ttrainer.TrainConfig(learning_rate=3e-4, warmup_updates=7, total_updates=20)
    ref = jtrainer.lr_schedule(jtrainer.TrainConfig(learning_rate=3e-4, warmup_updates=7, total_updates=20))
    sched = ttrainer.lr_schedule(cfg)
    for count in (0, 1, 3, 6, 7, 8, 13, 19, 20, 25):
        assert sched(count) == np.float32(ref(count)), count  # fp32 arithmetic, exact
    assert sched(0) == 0.0  # the first update uses schedule(0) (optax's count)


@pytest.mark.parametrize("clip", [1e-3, 1e3])  # clipping on every step / never
def test_adamw_update_matches_optax(clip):
    """Three AdamW ``optimizer_update``s against optax's clip + adamw chain on
    the same random tree: rtol 1e-6 (fp32 elementwise, op order differs)."""
    cfg = ttrainer.TrainConfig(learning_rate=1e-2, warmup_updates=2, total_updates=10, grad_clip=clip)
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.standard_normal((5, 7)).astype(np.float32)}, "b": rng.standard_normal(9).astype(np.float32)}
    opt = jtrainer.make_optimizer(jtrainer.TrainConfig(learning_rate=1e-2, warmup_updates=2, total_updates=10,
                                                       grad_clip=clip))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = opt.init(jparams)
    params = _to_torch(tree)
    opt_state = {"mu": jax.tree.map(torch.zeros_like, params), "nu": jax.tree.map(torch.zeros_like, params), "count": 0}
    for i in range(3):
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 10.0 ** (i - 1)).astype(np.float32), tree)
        updates, jstate = opt.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        ttrainer.optimizer_update(params, [g for _, g in tree_leaves(_to_torch(grads))], opt_state, "adamw",
                                  ttrainer.lr_schedule(cfg)(opt_state["count"]), cfg.weight_decay, cfg.grad_clip)
        for (name, p), (_, r) in zip(tree_leaves(params), tree_leaves(jax.tree.map(np.asarray, jparams))):
            np.testing.assert_allclose(p.numpy(), r, rtol=1e-6, atol=1e-8, err_msg=f"step {i} {name}")
    assert opt_state["count"] == 3


def test_two_train_steps_match_make_train_step():
    """Two updates (AdamW, clip, schedule, EMA) from the same params on the
    same batches and draws. The second update is the first with a nonzero
    learning rate. Params and EMA within 1e-3 of the step's lr (Adam divides
    gradients by their own magnitude, so gradient rounding shows up scaled
    to lr), loss and grad norm rtol 1e-4."""
    jcfg, tcfg = tiny_configs()
    common = dict(learning_rate=1e-3, warmup_updates=1, total_updates=10, grad_clip=0.05)
    ema_cfg = jema.EMAConfig(update_after_step=0, update_every=1)
    jtcfg = jtrainer.TrainConfig(**common, ema=ema_cfg)
    tcfg_train = ttrainer.TrainConfig(**common, ema=tema.EMAConfig(update_after_step=0, update_every=1))
    params = jax_params()
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    jstate = {**jstate, "params": jax.tree.map(jnp.asarray, params), "ema": jax.tree.map(jnp.asarray, params)}
    step = jax.jit(jtrainer.make_train_step(jcfg, jtcfg, compute_dtype=jnp.float32))
    state = ttrainer.init_train_state(tcfg, tcfg_train, "cpu", params_np=params)
    for i, seed in enumerate((4, 8)):
        mel, text, lens = batch(seed)
        key = jax.random.PRNGKey(100 + i)
        jstate, jm = step(jstate, {"mel": jnp.asarray(mel), "text": jnp.asarray(text), "lens": jnp.asarray(lens),
                                   "key": key})
        tb = {"mel": torch.as_tensor(mel), "text": torch.as_tensor(text), "lens": torch.as_tensor(lens)}
        tm = ttrainer.train_step(state, tb, [jax_draws(key, 2, 96, TINY["mel_dim"], jcfg)], tcfg, tcfg_train,
                                 torch.float32)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert float(jm["grad_norm"]) > common["grad_clip"]  # the clip is exercised
    assert state["step"] == int(jstate["step"]) == 2 and state["opt_state"]["count"] == 2
    for tree, ref in ((state["params"], jstate["params"]), (state["ema"], jstate["ema"])):
        ref = _flat(ref)
        for name, p in tree_leaves(tree):
            np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=1e-3 * common["learning_rate"], rtol=0,
                                       err_msg=name)
    moved = sum(float((p.detach() - torch.as_tensor(np.array(_flat(params)[n]))).abs().max()) > 0
                for n, p in tree_leaves(state["params"]))
    assert moved == len(tree_leaves(state["params"]))


def test_grad_accumulation_matches_the_manual_average():
    """Accumulation over two micro-batches of different lengths (pad-stacked
    by ``group_micro_batches``) against the mean of the two gradients taken
    one at a time on the same padded micro-batches; and a trailing partial
    group (weights 1, 0) against the lone batch. First moments after one
    update are (1 - b1) * grad (no clip): rtol 1e-5."""
    _, tcfg = tiny_configs()
    cfg = ttrainer.TrainConfig(learning_rate=1e-3, warmup_updates=1, total_updates=10, grad_clip=1e9)
    params = jax_params()
    jcfg, _ = tiny_configs()
    raw = [dict(zip(("mel", "text", "lens"), batch(4, n=96))), dict(zip(("mel", "text", "lens"), batch(6, n=64)))]
    group = next(ttrainer.group_micro_batches(iter(raw), 2))
    tgroup = {k: torch.as_tensor(group[k]) for k in ("mel", "text", "lens")}
    tgroup["micro_weight"] = group["micro_weight"]
    draws = [jax_draws(jax.random.PRNGKey(40 + i), 2, 96, TINY["mel_dim"], jcfg) for i in range(2)]

    def first_moments(b, d):
        state = ttrainer.init_train_state(tcfg, cfg, "cpu", params_np=params)
        metrics = ttrainer.train_step(state, b, d, tcfg, cfg, torch.float32)
        return {n: m / (1 - ttrainer.ADAM_B1) for n, m in tree_leaves(state["opt_state"]["mu"])}, metrics

    acc, acc_metrics = first_moments(tgroup, draws)
    singles = [first_moments({k: tgroup[k][i] for k in ("mel", "text", "lens")}, [draws[i]]) for i in range(2)]
    for name, g in acc.items():
        np.testing.assert_allclose(g.numpy(), ((singles[0][0][name] + singles[1][0][name]) / 2).numpy(),
                                   rtol=1e-5, atol=1e-9, err_msg=name)
    np.testing.assert_allclose(float(acc_metrics["loss"]),
                               (float(singles[0][1]["loss"]) + float(singles[1][1]["loss"])) / 2, rtol=1e-6)

    trailing = next(ttrainer.group_micro_batches(iter(raw[:1]), 2))
    assert list(trailing["micro_weight"]) == [1.0, 0.0]
    tt = {k: torch.as_tensor(trailing[k]) for k in ("mel", "text", "lens")}
    tt["micro_weight"] = trailing["micro_weight"]
    lone, _ = first_moments({k: torch.as_tensor(raw[0][k]) for k in ("mel", "text", "lens")}, draws[:1])
    padded, _ = first_moments(tt, draws)
    for name, g in lone.items():
        np.testing.assert_allclose(padded[name].numpy(), g.numpy(), rtol=1e-6, atol=1e-12, err_msg=name)


def test_group_micro_batches_and_pack_batches_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    raw = [{"mel": rng.standard_normal((b, n, 4)).astype(np.float32),
            "text": rng.integers(0, 9, (b, t)).astype(np.int32), "lens": rng.integers(1, n, (b,)).astype(np.int32)}
           for b, n, t in ((3, 40, 7), (2, 64, 5), (4, 32, 9), (1, 16, 3), (2, 48, 8))]
    for accum in (2, 3):
        for got, ref in zip(ttrainer.group_micro_batches(iter(raw), accum),
                            jtrainer.group_micro_batches(iter(raw), accum), strict=True):
            assert set(got) == set(ref)
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k])

    # a manifest of mel files and one 16 kHz wav (resampled, log-mel computed
    # by each package's own front end): the same packing, shuffle and batches
    texts = ["नमस्ते दुनिया", "hello there", "ನಮಸ್ಕಾರ", "a b c", "यह एक वाक्य है", "short", "one more line"]
    with open(tmp_path / "manifest.jsonl", "w", encoding="utf-8") as f:
        for i, text in enumerate(texts):
            frames = int(rng.integers(40, 600))
            np.save(tmp_path / f"m{i}.npy", rng.standard_normal((frames, 100)).astype(np.float32))
            f.write(json.dumps({"mel": f"m{i}.npy", "text": text}) + "\n")
        from f5tts_tpu_torch.audio.io import write_wav

        write_wav(str(tmp_path / "w.wav"), (0.1 * rng.standard_normal(16000)).astype(np.float32), 16000)
        f.write(json.dumps({"wav": "w.wav", "text": "broadband noise", "secs": 1.0}) + "\n")
    tds, jds = tdata.FramePackedDataset.from_dir(str(tmp_path)), jdata.FramePackedDataset.from_dir(str(tmp_path))
    assert tds.pack_batches(900, 3, seed=5) == jds.pack_batches(900, 3, seed=5)
    tb = list(tds.batches(900, max_samples=3, seed=5, epochs=2, frame_bucket=128))
    jb = list(jds.batches(900, max_samples=3, seed=5, epochs=2, frame_bucket=128))
    assert len(tb) == len(jb) > 2
    for got, ref in zip(tb, jb):
        for k in ("text", "lens"):
            np.testing.assert_array_equal(got[k], ref[k])
        # mel files pass through exactly; the wav's log-mel (torch.fft vs XLA's
        # FFT) agrees within 1e-4 on broadband input (ROADMAP C, "Log-mel")
        np.testing.assert_allclose(got["mel"], ref["mel"], atol=1e-4, rtol=0)


def test_ema_matches_jax_across_update_after_step():
    """Decay schedule exact in fp32; the EMA tree within 1 ulp-scale (rtol
    1e-6) over 130 steps across ``update_after_step`` and the cadence."""
    cfg_j, cfg_t = jema.EMAConfig(), tema.EMAConfig()
    for s in (0, 1, 100, 101, 102, 110, 111, 250, 10_000, 10**7):
        assert tema.ema_decay(s, cfg_t) == np.float32(jema.ema_decay(jnp.asarray(s, jnp.int32), cfg_j)), s
    rng = np.random.default_rng(3)
    p0 = {"w": rng.standard_normal((4, 6)).astype(np.float32), "b": rng.standard_normal(6).astype(np.float32)}
    jema_tree, tema_tree = jax.tree.map(jnp.asarray, p0), _to_torch(p0)
    for step in range(1, 131):
        p = jax.tree.map(lambda a: (a + 0.01 * step).astype(np.float32), p0)
        jema_tree = jema.ema_update(jema_tree, jax.tree.map(jnp.asarray, p), jnp.asarray(step, jnp.int32), cfg_j)
        tema.ema_update(tema_tree, _to_torch(p), step, cfg_t)
    for (name, e), (_, r) in zip(tree_leaves(tema_tree), tree_leaves(jax.tree.map(np.asarray, jema_tree))):
        np.testing.assert_allclose(e.numpy(), r, rtol=1e-6, err_msg=name)


def _tiny_trainer(tmp_path, **kw):
    _, tcfg = tiny_configs(dropout=0.1)
    cfg = ttrainer.TrainConfig(learning_rate=1e-3, warmup_updates=1, total_updates=10,
                               ema=tema.EMAConfig(update_after_step=0, update_every=1))
    return ttrainer.Trainer(tcfg, cfg, compute_dtype=torch.float32, checkpoint_dir=str(tmp_path / "ckpt"),
                            device="cpu", **kw)


def test_fit_with_grad_accum_groups_micro_batches(tmp_path):
    """``max_grad_accum = 2`` over three batches: two updates (the second a
    padded partial group), one logged line each, frames counted from the
    real batches."""
    _, tcfg = tiny_configs()
    cfg = ttrainer.TrainConfig(learning_rate=1e-3, warmup_updates=1, total_updates=10, max_grad_accum=2)
    logged = []
    trainer = ttrainer.Trainer(tcfg, cfg, compute_dtype=torch.float32, log_every=1, device="cpu",
                               logger=lambda **kw: logged.append(kw))
    state, _ = trainer.init_or_resume()
    batches = list(tdata.synthetic_batches(tcfg.model, frames=48, batch=2, n_batches=3, seed=2))
    state = trainer.fit(state, iter(batches))
    assert state["step"] == 2 and state["opt_state"]["count"] == 2
    assert [x["step"] for x in logged] == [1, 2]
    assert all(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"]) for x in logged)


def test_checkpoint_round_trip_keep_and_torn_fallback(tmp_path):
    trainer = _tiny_trainer(tmp_path, save_every=1)
    state, start = trainer.init_or_resume()
    assert start == 0
    batches = list(tdata.synthetic_batches(trainer.model_cfg.model, frames=64, batch=2, n_batches=4, seed=1))
    state = trainer.fit(state, batches)
    assert state["step"] == 4
    ckpt = str(tmp_path / "ckpt")
    assert sorted(os.listdir(ckpt)) == ["2", "3", "4"]  # newest 3 kept, no temp dirs left

    resumed, step = _tiny_trainer(tmp_path).init_or_resume()
    assert step == 4 and resumed["opt_state"]["count"] == 4
    for (name, a), (_, b) in zip(tree_leaves(resumed["params"]), tree_leaves(state["params"])):
        assert torch.equal(a.detach(), b.detach()) and a.requires_grad, name
    for (_, a), (_, b) in zip(tree_leaves(resumed["opt_state"]["nu"]), tree_leaves(state["opt_state"]["nu"])):
        assert torch.equal(a, b)

    with open(os.path.join(ckpt, "4", t_ckpt.STATE_FILE), "r+b") as f:  # tear the newest step
        f.truncate(100)
    resumed, step = _tiny_trainer(tmp_path).init_or_resume()
    assert step == 3 and resumed["step"] == 3


def test_trained_params_export_serves_in_both_packages(tmp_path):
    """A port checkpoint's EMA params, exported to the JAX ``.npz``, load in
    the JAX package and give the port's forward (atol 1e-4)."""
    trainer = _tiny_trainer(tmp_path, save_every=2)
    state, _ = trainer.init_or_resume()
    trainer.fit(state, tdata.synthetic_batches(trainer.model_cfg.model, frames=64, batch=2, n_batches=2))
    path = str(tmp_path / "trained.npz")
    t_convert.export_trained_params(str(tmp_path / "ckpt"), path)
    jp = j_convert.load_params_npz(path)
    ema = t_convert.load_trained_checkpoint(str(tmp_path / "ckpt"))
    for name, a in _flat(ema).items():
        np.testing.assert_array_equal(_flat(jp)[name], a)
    x, cond, text, mask = (np.random.default_rng(1).standard_normal((1, 48, 20)).astype(np.float32),
                           np.zeros((1, 48, 20), np.float32), np.arange(10, dtype=np.int32)[None], None)
    jcfg = jd.DiTConfig(**TINY)
    ref = jd.dit_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(text), jnp.asarray(0.5),
                         jnp.zeros((1,), bool), jnp.zeros((1,), bool))
    out = td.dit_forward(t_convert.dit_params_from_numpy(t_convert.load_params_npz(path), "cpu"),
                         dataclasses.replace(trainer.model_cfg.model, attn_impl="plain", conv_pos_impl="plain"),
                         torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(text), torch.tensor(0.5),
                         torch.zeros((1,), dtype=torch.bool), torch.zeros((1,), dtype=torch.bool))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_cli_smoke_on_cpu_and_no_silent_cpu_fallback(monkeypatch, capsys):
    state = t_cli.main(["--smoke", "--device", "cpu"])
    assert state["step"] == 3
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["step"] for x in lines] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) and x["frames_per_s"] > 0 for x in lines)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cli.main(["--smoke"])


def test_jsonl_logger_appends_and_echoes(tmp_path, capsys):
    from f5tts_tpu_torch.train.metrics import JsonlLogger

    path = tmp_path / "log.jsonl"
    log = JsonlLogger(str(path))
    log(step=1, loss=0.5)
    log(step=2, loss=0.25)
    log.close()
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert [(r["step"], r["loss"]) for r in recs] == [(1, 0.5), (2, 0.25)] and all("ts" in r for r in recs)
    assert capsys.readouterr().out.count('"step"') == 2


def test_cli_train_config_fills_defaults():
    p = t_cli.build_argparser()
    args = p.parse_args(["--train-config", os.path.join(os.path.dirname(__file__), "..", "configs",
                                                        "F5TTS_Base_train.yaml"), "--grad-accum", "2"])
    t_cli.apply_train_config(p, args)
    assert (args.model, args.batch_frames, args.warmup_updates, args.grad_accum) == ("F5TTS_Base", 38400, 20000, 2)
    assert t_cli.resolve_model_cfg("F5TTS_Small").model.dim == 768
