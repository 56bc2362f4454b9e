"""Multi-process dry run on the CPU (counterpart of
``__graft_entry__.py:dryrun_multichip``), and the worker functions of the
port's multi-device tests.

``python -m f5tts_tpu_torch.parallel.dryrun [n]`` spawns ``n`` (default 4)
CPU processes over gloo (a ``file://`` rendezvous in a temporary directory)
and runs, at a tiny width, one data x tensor parallel train step and one
tensor-parallel guided ODE solve on the ``(n // 2, 2)`` mesh (``(n, 1)``
for odd ``n``). Every spawn here has a time limit: a hang fails the call.

The test workers (``parity_worker``, ``ring_worker``) read their inputs from
a pickle the test wrote and write each rank's results next to it; they import
nothing of JAX (the tests compare the results with the JAX package in the
parent process).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from f5tts_tpu_torch.train.tree import tree_leaves, tree_map

SPAWN_TIMEOUT_S = 120.0


def _entry(fn, rank: int, world: int, init_file: str, args: tuple, err_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world, rank=rank)
        try:
            fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(err_dir, f"error_{rank}.txt"), "w", encoding="utf-8") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, world: int, args: tuple = (), workdir: str | None = None, timeout: float = SPAWN_TIMEOUT_S) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh CPU processes joined
    by gloo, and wait at most ``timeout`` seconds for all of them. Raises
    with the failing ranks' tracebacks, or when the time runs out (the
    processes are killed then). ``fn`` must be importable (a module-level
    function): the processes start from a fresh interpreter."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_entry, args=(fn, r, world, init_file, args, tmp), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errors = [open(os.path.join(tmp, f), encoding="utf-8").read()
                  for f in sorted(os.listdir(tmp)) if f.startswith("error_")]
        if hung:
            raise TimeoutError(f"ranks {hung} still running after {timeout:.0f} s" + "".join(errors))
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"ranks {failed} failed:\n" + "\n".join(errors))


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def dryrun_rank(rank: int, world: int, out_dir: str | None = None) -> dict:
    """One rank of the dry run (the process group is up): one DP x TP train
    step and one TP-sharded guided solve at a tiny width. Returns (and, with
    ``out_dir``, writes) the rank's summary."""
    from f5tts_tpu_torch.models.cfm import CFMConfig
    from f5tts_tpu_torch.models.dit import DiTConfig
    from f5tts_tpu_torch.parallel.launcher import global_mesh
    from f5tts_tpu_torch.sampling.euler import SamplerConfig, sample_cfm
    from f5tts_tpu_torch.train.trainer import TrainConfig, Trainer

    model_parallel = 2 if world % 2 == 0 else 1
    mesh = global_mesh(model_parallel, device="cpu")
    data_par = mesh["data"].size
    model = DiTConfig(dim=128, depth=2, heads=4, dim_head=32, ff_mult=2, mel_dim=20, text_num_embeds=40,
                      text_dim=64, conv_layers=2, max_pos=256)
    trainer = Trainer(CFMConfig(model=model), TrainConfig(warmup_updates=10, total_updates=100),
                      compute_dtype=torch.float32, mesh=mesh)
    state, _ = trainer.init_or_resume()
    b, n, nt = max(2 * data_par, 2), 64, 24
    rng = np.random.default_rng(0)
    batch = {"mel": rng.standard_normal((b, n, 20)).astype(np.float32),
             "text": rng.integers(0, 40, (b, nt)).astype(np.int32), "lens": np.full((b,), n, np.int32)}
    loss = float(trainer.step(state, batch)["loss"])
    if not np.isfinite(loss) or state["step"] != 1:
        raise RuntimeError(f"train step failed: loss {loss}, step {state['step']}")

    from f5tts_tpu_torch.models.dit import dit_forward

    with torch.no_grad():
        mel = sample_cfm(
            state["params"], model, cond=torch.as_tensor(rng.standard_normal((b, n, 20)), dtype=torch.float32),
            cond_lens=torch.full((b,), 16), text=torch.as_tensor(rng.integers(0, 40, (b, nt))),
            duration=torch.full((b,), n), sampler=SamplerConfig(steps=2, method="ralston"), seeds=list(range(b)),
            forward_fn=functools.partial(dit_forward, tp=mesh["model"]))
    if tuple(mel.shape) != (b, n, 20) or not torch.isfinite(mel).all():
        raise RuntimeError("serving solve failed")
    out = {"mesh": mesh.shape, "loss": loss, "serve_mel_rms": float(mel.square().mean().sqrt())}
    if out_dir is not None:
        with open(os.path.join(out_dir, f"dryrun_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    return out


def dryrun_multichip(n_devices: int = 4, timeout: float = SPAWN_TIMEOUT_S) -> list[dict]:
    """Spawn ``n_devices`` gloo CPU processes and run ``dryrun_rank`` on each;
    returns every rank's summary (which agree)."""
    with tempfile.TemporaryDirectory() as out_dir:
        spawn(dryrun_rank, n_devices, (out_dir,), timeout=timeout)
        outs = []
        for r in range(n_devices):
            with open(os.path.join(out_dir, f"dryrun_{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    o = outs[0]
    print(f"dryrun_multichip ok: mesh={o['mesh']} loss={o['loss']:.4f} serve_mel_rms={o['serve_mel_rms']:.4f}")
    return outs


# ---------------------------------------------------------------------------
# the tests' workers
# ---------------------------------------------------------------------------


def _load(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _dump(obj, out_dir: str, name: str, rank: int) -> None:
    with open(os.path.join(out_dir, f"{name}_{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def _np_tree(tree):
    def host(t):  # numpy has no bf16: Adafactor's momentum goes out as fp32 (exact)
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(lambda t: host(t) if isinstance(t, torch.Tensor) else t, tree)


def _global_grads(params, mesh):
    """The whole gradient tree: summed over ``data``, gathered over ``model``."""
    from f5tts_tpu_torch.parallel.sharding import unshard_params

    grads = tree_map(lambda t: mesh["data"].all_reduce(t.grad.clone()), params)
    return _np_tree(unshard_params(grads, mesh))


def parity_worker(rank: int, world: int, inputs_path: str, out_dir: str) -> None:
    """The (2, 2), (1, 4) and (4, 1) mesh checks of the tests: TP forwards
    (the DiT, the UNetT),
    the DP x TP loss and gradients, Trainer steps (AdamW, Adafactor), a
    checkpoint saved under TP and restored, the engine, the train CLI, the
    MMDiT under DP and under DP x TP (forward, loss and gradients, a Trainer
    step), a row-parallel int8 linear at (1, 4) and the int8 engine at
    (2, 2). Writes ``parity_<rank>.pkl``."""
    from f5tts_tpu_torch.cli import train as train_cli
    from f5tts_tpu_torch.engine.engine import TTSEngine
    from f5tts_tpu_torch.models.cfm import CFMDraws, cfm_loss
    from f5tts_tpu_torch.models.convert import dit_params_from_numpy, params_from_numpy
    from f5tts_tpu_torch.models.dit import dit_forward
    from f5tts_tpu_torch.models.mmdit import mmdit_forward
    from f5tts_tpu_torch.models.modules import quantize_linear_params, row_parallel_linear
    from f5tts_tpu_torch.parallel.mesh import build_mesh
    from f5tts_tpu_torch.parallel.sharding import shard_params
    from f5tts_tpu_torch.text.tokenizer import Tokenizer
    from f5tts_tpu_torch.train.trainer import Trainer, init_train_state

    inp = _load(inputs_path)
    out = {}
    mesh22 = build_mesh(2, device="cpu")
    mesh14 = build_mesh(4, device="cpu")
    mesh41 = build_mesh(1, device="cpu")

    # TP forwards (no grad): (2, 2) and one head per rank
    cfg = inp["tiny"]
    full = dit_params_from_numpy(inp["dit_np"], "cpu", torch.float32)
    x, cond, text, time = (torch.as_tensor(a) for a in inp["fwd_batch"])
    f = torch.zeros((x.shape[0],), dtype=torch.bool)
    with torch.no_grad():
        for name, mesh in (("fwd_22", mesh22), ("fwd_14", mesh14)):
            out[name] = dit_forward(shard_params(full, mesh), cfg, x, cond, text, time, f, f,
                                    tp=mesh["model"]).numpy()
        from f5tts_tpu_torch.models.unett import unett_forward

        ucfg, unp = inp["unett"]
        out["unett_22"] = unett_forward(shard_params(params_from_numpy(unp, "cpu", torch.float32), mesh22), ucfg, x,
                                        cond, text, time, f, f, tp=mesh22["model"]).numpy()

    # DP x TP loss and gradients against the JAX value_and_grad (rows of the global batch)
    mel, text_l, lens = (torch.as_tensor(a) for a in inp["loss_batch"])
    d = inp["loss_draws"]
    sl = slice(mesh22["data"].index * 2, mesh22["data"].index * 2 + 2)
    draws = CFMDraws(*(torch.as_tensor(d[k]) for k in ("frac_lengths", "span_rand", "x0", "t")),
                     d["drop_audio"], d["drop_both"], 0).rows(sl)
    params = shard_params(params_from_numpy(inp["dit_np"], "cpu", torch.float32), mesh22)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    loss, aux = cfm_loss(params, inp["loss_cfg"], draws, mel[sl], text_l[sl], lens[sl], mesh=mesh22)
    loss.backward()
    out["loss"] = float(mesh22["data"].all_reduce(loss.detach().clone()))
    out["masked_frames"] = int(aux["masked_frames"])
    out["grads"] = _global_grads(params, mesh22)

    # Trainer steps under the (2, 2) mesh; the whole state after each
    for opt, (model_cfg, train_cfg) in inp["trainers"].items():
        trainer = Trainer(model_cfg, train_cfg, compute_dtype=torch.float32, device="cpu", mesh=mesh22)
        state = trainer.shard(init_train_state(model_cfg, train_cfg, "cpu", inp["train_np"]))
        batches = inp["train_batches"] if opt == "adamw" else inp["adafactor_batches"]
        metrics = [{k: float(v) for k, v in trainer.step(state, b).items()} for b in batches]
        out[f"train_{opt}"] = {"metrics": metrics, "state": _np_tree(trainer.whole(state))}

    # a checkpoint saved under TP (whole, by rank 0), restored and re-sharded
    model_cfg, train_cfg = inp["trainers"]["adamw"]
    ckpt = os.path.join(out_dir, "ckpt")
    trainer = Trainer(model_cfg, train_cfg, compute_dtype=torch.float32, device="cpu", mesh=mesh22,
                      checkpoint_dir=ckpt, save_every=1)
    state = trainer.shard(init_train_state(model_cfg, train_cfg, "cpu", inp["train_np"]))
    trainer.fit(state, inp["train_batches"][:1])
    resumed, step = Trainer(model_cfg, train_cfg, compute_dtype=torch.float32, device="cpu", mesh=mesh22,
                            checkpoint_dir=ckpt).init_or_resume()
    pairs = zip(tree_leaves(resumed["params"]), tree_leaves(state["params"]))
    same = all(torch.equal(a, b) for (_, a), (_, b) in pairs)
    out["ckpt"] = {"step": step, "reshards_equal": same, "whole": _np_tree(trainer.whole(state)["params"])}

    # the engine (each data replica tensor-parallel over 2 ranks), fp32
    e = inp["engine"]
    engine = TTSEngine(e["dit_np"], e["dit_cfg"], e["voc_np"], Tokenizer(e["vocab"]), e["cfg"], device="cpu",
                       mesh=mesh22)
    out["wave"] = engine.synthesize(e["text"], e["ref"], 24000, e["ref_text"], seed=7)[0]

    # the MMDiT trains data-parallel
    model_cfg, train_cfg = inp["mmdit"]["cfgs"]
    trainer = Trainer(model_cfg, train_cfg, compute_dtype=torch.float32, device="cpu", mesh=mesh41)
    state = trainer.shard(init_train_state(model_cfg, train_cfg, "cpu", inp["mmdit"]["np"]))
    out["mmdit"] = {"loss": float(trainer.step(state, inp["mmdit"]["batch"])["loss"]),
                    "params": _np_tree(state["params"])}

    # the MMDiT under DP x TP: a forward, the loss and gradients, a Trainer step
    mm = inp["mmdit"]
    model_cfg, train_cfg = mm["cfgs"]
    with torch.no_grad():
        out["mmdit_fwd_22"] = mmdit_forward(shard_params(params_from_numpy(mm["np"], "cpu", torch.float32), mesh22),
                                            model_cfg.model, x, cond, text, time, f, f, tp=mesh22["model"]).numpy()
    params = shard_params(params_from_numpy(mm["np"], "cpu", torch.float32), mesh22)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    loss, _ = cfm_loss(params, model_cfg, draws, mel[sl], text_l[sl], lens[sl], mesh=mesh22)
    loss.backward()
    out["mmdit_loss_22"] = float(mesh22["data"].all_reduce(loss.detach().clone()))
    out["mmdit_grads_22"] = _global_grads(params, mesh22)
    trainer = Trainer(model_cfg, train_cfg, compute_dtype=torch.float32, device="cpu", mesh=mesh22)
    state = trainer.shard(init_train_state(model_cfg, train_cfg, "cpu", mm["np"]))
    out["mmdit_22"] = {"loss": float(trainer.step(state, mm["batch"])["loss"]),
                       "params": _np_tree(trainer.whole(state)["params"])}

    # int8 under TP: a row-parallel linear at (1, 4) (its K-shards, the scales of the whole weight), and the
    # int8 engine at (2, 2) through its bucket program with explicit noise
    lin = inp["int8_linear"]
    tp = mesh14["model"]
    ks = lin["w"].shape[0] // tp.size
    ksl = slice(tp.index * ks, (tp.index + 1) * ks)
    out["int8_linear"] = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        w, b, xl = (torch.as_tensor(lin[k]).to(dtype) for k in ("w", "b", "x"))
        q = quantize_linear_params({"w": w[ksl], "b": b}, tp)
        with torch.no_grad():
            y = row_parallel_linear(q, xl[..., ksl], tp)
        out["int8_linear"][name] = {"y": y.float().numpy(), "s_w": q["s_w"].numpy(), "w_q": q["w_q"].numpy()}
    e8 = inp["engine_int8"]
    engine = TTSEngine(e8["dit_np"], e8["dit_cfg"], e8["voc_np"], Tokenizer(e8["vocab"]), e8["cfg"], device="cpu",
                       mesh=mesh22)
    with torch.no_grad():
        gen, wave = engine.bucket_program(*(torch.as_tensor(a) for a in e8["program"]), steps=2, cfg_strength=2.0,
                                          y0=torch.as_tensor(e8["y0"]))
    out["int8_engine"] = {"gen": gen.numpy(), "wave": wave.numpy()}

    # the train CLI under the launcher's mesh
    state = train_cli.main(["--smoke", "--device", "cpu", "--model-parallel", "2"])
    out["cli"] = {"step": state["step"], "finite": all(bool(torch.isfinite(t).all())
                                                      for _, t in tree_leaves(state["params"]))}
    _dump(out, out_dir, "parity", rank)


def ring_worker(rank: int, world: int, inputs_path: str, out_dir: str) -> None:
    """The context-parallel checks: ring attention with and without a mask
    (its output, and the q/k/v gradients of a fixed linear function of it),
    the DiT with ``attn_impl="ring"`` (its forward, and the parameter
    gradients of a training loss through the ring), and the dry run's rank
    body. Writes ``ring_<rank>.pkl``."""
    from f5tts_tpu_torch.models.convert import dit_params_from_numpy
    from f5tts_tpu_torch.models.dit import dit_forward
    from f5tts_tpu_torch.parallel.mesh import build_mesh
    from f5tts_tpu_torch.parallel.ring_attention import ring_attention

    inp = _load(inputs_path)
    cp = build_mesh(world, device="cpu", axis_names=("data", "cp"))["cp"]
    out = {}
    q, k, v = (torch.as_tensor(a) for a in inp["qkv"])
    with torch.no_grad():
        for name, mask in (("ring", None), ("ring_masked", torch.as_tensor(inp["mask"]))):
            out[name] = ring_attention(q, k, v, mask, cp).numpy()
        f = inp["fwd"]
        cfg = dataclasses.replace(f["cfg"], attn_impl="ring")
        params = dit_params_from_numpy(f["np"], "cpu", torch.float32)
        x, text, t, mask = (torch.as_tensor(a) for a in f["inputs"])
        drop = torch.zeros((x.shape[0],), dtype=torch.bool)
        out["dit_ring"] = dit_forward(params, cfg, x, x, text, t, drop, drop, mask, cp=cp).numpy()
    g = torch.as_tensor(inp["upstream"])
    for name, m in (("ring_grads", None), ("ring_masked_grads", torch.as_tensor(inp["mask"]))):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (ring_attention(*leaves, m, cp) * g).sum().backward()
        out[name] = [t.grad.numpy() for t in leaves]
    params = tree_map(lambda t: t.requires_grad_(True), params)
    y = dit_forward(params, cfg, x, x, text, t, drop, drop, mask, training=True, cp=cp)
    (y * torch.as_tensor(f["target"]) * mask[..., None]).sum().backward()
    out["dit_ring_grads"] = _np_tree(tree_map(lambda t: t.grad, params))
    out["dryrun"] = dryrun_rank(rank, world)
    _dump(out, out_dir, "ring", rank)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
