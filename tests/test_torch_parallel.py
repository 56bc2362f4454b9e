"""The port's multi-device layer (``f5tts_tpu_torch/parallel``, the mesh of
the engine and the trainer) against the JAX package on the CPU, over gloo.

Two spawns of 4 processes (``parallel/dryrun.py``'s ``spawn``, a file
rendezvous under ``tmp_path``, one torch thread each, 120 s each) run the
workers of ``parallel/dryrun.py``; the comparisons with the JAX package run
here. The JAX tests' ``TINY`` DiT (dim 64, depth 2, 4 heads of 16), weights
from ``init_dit`` as numpy, fp32, JAX matmul precision ``highest``, TF32 off.
Tolerances: the TP forward as ``tests/test_sharding.py`` (atol 2e-4, rtol
1e-4), at (2, 2) and at one head per rank (1, 4), which pins the head-0 RoPE
on model rank 0; the DP x TP loss within 1e-4 and each gradient leaf within
2e-2 relative L2 of JAX's ``value_and_grad``; Trainer steps (AdamW, and
Adafactor with accumulation; dropout on, clip biting) against the port's
one-device steps at rtol 1e-5 (atol 1e-5, a hundredth of the learning rate:
AdamW's ``g / (|g| + eps)`` magnifies the rounding of gradients near eps;
Adafactor's key bias, whose gradient is zero up to rounding, within the move
of its two updates, as ``tests/test_torch_train_extras.py`` holds it); the ring as
``tests/test_ring_attention.py`` (2e-5 / 1e-5; 3e-4 / 1e-3 for the DiT). The
MMDiT under (2, 2) with the DiT's tolerances. Int8 under TP is bit-equal to
the port's one-device int8 path (integer sums are exact) and within
``tests/test_torch_quant.py``'s tolerances of the JAX package (a linear rtol
1e-6, the engine 1e-3 relative L2). The ring's q/k/v gradients within the
forward's 2e-5 / 1e-5 of ``jax.grad`` through the JAX ring; the ring DiT's
parameter gradients within 1e-4 relative L2 per leaf (fp32 sums over
another grouping: measured 4.5e-6).
"""

import dataclasses
import pickle
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from f5tts_tpu.engine import engine as j_engine
from f5tts_tpu.models import cfm as jcfm
from f5tts_tpu.models import dit as jd
from f5tts_tpu.models import mmdit as jmm
from f5tts_tpu.models import modules as jm
from f5tts_tpu.models import unett as ju
from f5tts_tpu.models import vocos as jv
from f5tts_tpu.ops.attention import sdpa_xla
from f5tts_tpu.ops.mel import MelConfig as JMelConfig
from f5tts_tpu.parallel.ring_attention import ring_attention as j_ring_attention
from f5tts_tpu.sampling import euler as je
from f5tts_tpu.text.tokenizer import Tokenizer as JTokenizer
from f5tts_tpu.parallel.sharding import dit_param_specs as j_specs
from f5tts_tpu.parallel.sharding import vocos_param_specs as j_vocos_specs
from f5tts_tpu_torch.engine.engine import EngineConfig, TTSEngine
from f5tts_tpu_torch.models import cfm as tcfm
from f5tts_tpu_torch.models import dit as td
from f5tts_tpu_torch.models.convert import (dit_params_from_numpy, init_dit_numpy, init_mmdit_numpy,
                                            init_unett_numpy, init_vocos_numpy)
from f5tts_tpu_torch.models import modules as tm
from f5tts_tpu_torch.models.mmdit import MMDiTConfig
from f5tts_tpu_torch.models.unett import UNetTConfig
from f5tts_tpu_torch.models.vocos import VocosConfig
from f5tts_tpu_torch.ops.mel import MelConfig
from f5tts_tpu_torch.parallel import dryrun, launcher
from f5tts_tpu_torch.parallel.mesh import Axis, Mesh, build_mesh
from f5tts_tpu_torch.parallel.sharding import dit_param_specs, shard_tensor, sharded_axis, vocos_param_specs
from f5tts_tpu_torch.sampling.euler import serving_default_sampler
from f5tts_tpu_torch.text.tokenizer import Tokenizer
from f5tts_tpu_torch.train.checkpoint import restore_latest
from f5tts_tpu_torch.train.ema import EMAConfig
from f5tts_tpu_torch.train.trainer import TrainConfig, Trainer, group_micro_batches, init_train_state
from f5tts_tpu_torch.train.tree import tree_leaves

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, mel_dim=20, text_num_embeds=30, text_dim=32,
            conv_layers=1, max_pos=256)
TRAIN = dict(TINY, dim=128, dim_head=32)  # Adafactor factors leaves with two axes >= 128
ENGINE_DIT = dict(TINY, text_num_embeds=95, max_pos=1024)
VOC = dict(input_channels=20, dim=48, intermediate_dim=96, num_layers=2)
VOCAB = {" ": 0, **{chr(i): i - 31 for i in range(33, 127)}}
RING_DIT = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_num_embeds=30, text_dim=32,
                conv_layers=1, max_pos=256)
WORLD = 4
# a parameter after AdamW's steps: its update g / (|g| + eps) turns the summation-order rounding of a gradient
# near eps into up to ~1e-2 of the learning rate (1e-3), so an element may move 1e-5 apart
STEP_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, list):  # a spec is a tuple: a leaf here
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}/{i}"))
        return out
    return {} if tree is None else {prefix: tree}


def host_flat(tree) -> dict:
    """``flat`` with tensors as numpy (bf16 as fp32, exact)."""
    def host(v):
        if isinstance(v, torch.Tensor):
            v = v.detach()
            return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        return np.asarray(v)

    return {k: host(v) for k, v in flat(tree).items()}


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)), 1e-12))


def jax_draws(key, b, n, mel_dim, cfg) -> dict:
    """The draws of the JAX ``cfm_loss`` for ``key`` (its 7-way split)."""
    k_frac, k_span, k_x0, k_t, k_drop1, k_drop2, _ = jax.random.split(key, 7)
    lo, hi = cfg.frac_lengths_mask
    return {"frac_lengths": np.array(jax.random.uniform(k_frac, (b,), minval=lo, maxval=hi)),
            "span_rand": np.array(jax.random.uniform(k_span, (b,))),
            "x0": np.array(jax.random.normal(k_x0, (b, n, mel_dim), jnp.float32)),
            "t": np.array(jax.random.uniform(k_t, (b,), dtype=jnp.float32)),
            "drop_audio": bool(jax.random.uniform(k_drop1, ()) < cfg.audio_drop_prob),
            "drop_both": bool(jax.random.uniform(k_drop2, ()) < cfg.cond_drop_prob)}


def train_batches(seed: int, b: int = 4, n: int = 48, count: int = 2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        text = rng.integers(0, TINY["text_num_embeds"], (b, 16)).astype(np.int32)
        text[1, 10:] = -1
        out.append({"mel": rng.standard_normal((b, n, 20)).astype(np.float32), "text": text,
                    "lens": np.array([n, 40, n, 33][:b], np.int32)})
    return out


def trainer_cfgs():
    model = tcfm.CFMConfig(model=td.DiTConfig(**TRAIN))  # dropout 0.1: the mesh redraws the one-device masks
    ema = EMAConfig(update_after_step=0, update_every=1)
    base = dict(learning_rate=1e-3, warmup_updates=0, total_updates=10, grad_clip=0.05, ema=ema, seed=3)
    return {"adamw": (model, TrainConfig(**base)),
            "adafactor": (model, TrainConfig(**base, optimizer="adafactor", max_grad_accum=2))}


def adafactor_batches():
    """One update from two accumulated micro-batches, then a plain one."""
    a, b = train_batches(11)
    return [next(group_micro_batches([a, b], 2)), train_batches(12, count=1)[0]]


# ---------------------------------------------------------------------------
# no processes: specs, shards, the launcher's parsing, the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["dit", "unett", "mmdit", "vocos"])
def test_param_specs_match_jax(family):
    """The trees of the port's seeded inits, which are the JAX inits' trees."""
    if family == "vocos":  # replicated whole
        tree = init_vocos_numpy(VocosConfig(**VOC))
        ref = {k: tuple(v) for k, v in flat(j_vocos_specs(tree)).items()}
        assert flat(vocos_param_specs(tree)) == ref and set(ref.values()) == {()}
        return
    if family == "dit":
        tree = init_dit_numpy(td.DiTConfig(**TINY))
    elif family == "unett":
        tree = init_unett_numpy(UNetTConfig(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, mel_dim=8,
                                            text_num_embeds=20, text_dim=16, conv_layers=1))
    else:
        tree = init_mmdit_numpy(MMDiTConfig(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, mel_dim=8,
                                            text_num_embeds=20))
    ref = {k: tuple(v) for k, v in flat(j_specs(tree)).items()}
    got = flat(dit_param_specs(tree))
    assert got == ref and any("model" in s for s in got.values())
    if family == "mmdit":  # the key rule: to_out_c column-parallel, the feed-forwards replicated
        assert got["blocks/attn/to_out_c/w"] == (None, None, "model")
        assert got["blocks/ff_x/in/w"] == ()


@pytest.mark.parametrize("size", [2, 4])
def test_shards_cover_each_leaf_once(size):
    tree = dit_params_from_numpy(init_dit_numpy(td.DiTConfig(**TINY), seed=1), "cpu")
    specs = flat(dit_param_specs(tree))
    for path, t in tree_leaves(tree):
        s = specs[path]
        shards = [shard_tensor(t, s, size, i) for i in range(size)]
        ax = sharded_axis(s)
        whole = shards[0] if ax is None else torch.cat(shards, ax)
        assert torch.equal(whole, t), path
        if ax is not None:
            assert shards[1].shape[ax] == t.shape[ax] // size and shards[1].is_contiguous()


def test_launcher_reads_the_jax_variables(monkeypatch):
    for k in ("NUM_PROCESSES", "PROCESS_ID", "COORDINATOR_ADDRESS", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert launcher.init_distributed(device="cpu") == (0, 1)  # one process: nothing to join
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    with pytest.raises(RuntimeError, match="COORDINATOR_ADDRESS"):
        launcher.init_distributed(device="cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    from f5tts_tpu_torch.parallel.mesh import local_rank, mesh_device

    assert local_rank() == 3 and mesh_device("cpu") == torch.device("cpu")
    assert build_mesh(1, device="cpu").shape == (1, 1)  # no process group: a one-rank mesh
    with pytest.raises(ValueError):
        build_mesh(2, device="cpu")


def fake_mesh(data: int, data_index: int, model: int = 1, model_index: int = 0) -> Mesh:
    """A mesh as one rank of a larger world sees it (no process group: only
    what runs before a collective may use it)."""
    return Mesh((Axis("data", data, data_index, tuple(range(data))), Axis("model", model, model_index,
                                                                         tuple(range(model)))),
                torch.device("cpu"), rank=data_index * model + model_index, world=data * model)


def test_local_batch_slice_and_global_batch():
    assert launcher.local_batch_slice(8, fake_mesh(2, 1, 2, 1)) == slice(4, 8)
    assert launcher.local_batch_slice(6, fake_mesh(3, 0, 2, 1)) == slice(0, 2)
    assert launcher.local_batch_slice(5) == slice(0, 5)  # no process group: the whole batch
    with pytest.raises(ValueError, match="divide"):
        launcher.local_batch_slice(5, fake_mesh(2, 0))
    batch = launcher.make_global_batch({"lens": np.array([3, 4], np.int32)}, fake_mesh(1, 0))
    assert batch["lens"].device.type == "cpu" and batch["lens"].tolist() == [3, 4]


def test_mmdit_under_context_parallelism_raises():
    """What still raises: the MMDiT with a ``cp`` axis (the JAX MMDiT has no
    ring path; its joint attention is always ``sdpa_xla``)."""
    from f5tts_tpu_torch.models.convert import params_from_numpy
    from f5tts_tpu_torch.models.mmdit import mmdit_forward

    mcfg = MMDiTConfig(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, mel_dim=8, text_num_embeds=20)
    params = params_from_numpy(init_mmdit_numpy(mcfg), "cpu")
    x = torch.zeros((1, 16, 8))
    f = torch.zeros((1,), dtype=torch.bool)
    cp = fake_mesh(1, 0, 2, 0)["model"]
    with pytest.raises(NotImplementedError, match="no context-parallel path"):
        mmdit_forward(params, mcfg, x, x, torch.zeros((1, 4), dtype=torch.int32), torch.zeros(1), f, f, cp=cp)


def start_spawn(worker, inputs: dict, tmp, name: str):
    """Write ``inputs``, start the 4-rank spawn of ``worker`` in a thread (the
    JAX references are computed meanwhile) and return a callable that waits
    for it (within the spawn's own time limit) and returns each rank's
    results."""
    path = tmp / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    failure = []

    def target():
        try:
            dryrun.spawn(worker, WORLD, (str(path), str(tmp)), workdir=str(tmp))
        except Exception as e:  # re-raised by the test that waits
            failure.append(e)

    thread = threading.Thread(target=target, daemon=True)
    thread.start()

    def wait():
        thread.join(dryrun.SPAWN_TIMEOUT_S + 30)
        assert not thread.is_alive(), "the spawn outlived its time limit"
        if failure:
            raise failure[0]
        outs = []
        for r in range(WORLD):
            with open(tmp / f"{name}_{r}.pkl", "rb") as f:
                outs.append(pickle.load(f))
        return outs

    return wait


def test_ring_body_over_local_blocks_matches_sdpa():
    """The per-shard body driven in one process over the rotated blocks (as
    the card checks it): row 0 has a wholly masked shard, row 1 no valid key
    at all (every hop's lse is -1e30: the hops weigh alike, as ``sdpa``
    averages every value)."""
    from f5tts_tpu_torch.parallel.ring_attention import LocalTransport, ring_body, seq_blocks

    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 2, 64, 16)).astype(np.float32) for _ in range(3))
    mask = np.ones((2, 64), bool)
    mask[0, 40:] = False
    mask[1, :] = False
    tq, tk, tv, tm = (torch.as_tensor(a) for a in (q, k, v, mask))
    kb, vb, mb = seq_blocks(tk, 4, 2), seq_blocks(tv, 4, 2), seq_blocks(tm, 4, 1)
    blocks = list(zip(kb, vb, mb))
    o = torch.cat([ring_body(seq_blocks(tq, 4, 2)[r], kb[r], vb[r], mb[r], 4, LocalTransport(blocks, r))
                   for r in range(4)], 2)
    ref = np.asarray(sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
    np.testing.assert_allclose(o.numpy(), ref, atol=2e-5, rtol=1e-5)


def test_ring_backward_over_local_blocks_matches_sdpa():
    """The ring's backward body driven in one process (as the card checks
    it): every rank's forward, then its backward over the same rotated blocks
    with one shared dict of dK/dV accumulators; the gathered dq, dk, dv
    against plain ``sdpa`` autograd over the whole sequence. Row 0 has a
    wholly masked shard (its keys' dk and dv are zero in both)."""
    from f5tts_tpu_torch.ops.attention import sdpa
    from f5tts_tpu_torch.parallel.ring_attention import LocalTransport, ring_body_bwd, ring_forward, seq_blocks

    rng = np.random.default_rng(4)
    q, k, v, do = (torch.as_tensor(rng.standard_normal((2, 2, 64, 16)).astype(np.float32)) for _ in range(4))
    mask = torch.ones((2, 64), dtype=torch.bool)
    mask[0, 40:] = False
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (sdpa(*leaves, mask) * do).sum().backward()
    p = 4
    qb, kb, vb, mb, dob = (seq_blocks(t, p, 1 if t.ndim == 2 else 2) for t in (q, k, v, mask, do))
    blocks, shared = list(zip(kb, vb, mb)), {}
    grads = []
    for r in range(p):
        o, lse = ring_forward(qb[r], kb[r], vb[r], mb[r], p, LocalTransport(blocks, r))
        grads.append(ring_body_bwd(qb[r], kb[r], vb[r], mb[r], o, lse, dob[r], p, LocalTransport(blocks, r, shared)))
    for i, leaf in enumerate(leaves):
        got = torch.cat([g[i] for g in grads], 2)
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), atol=2e-5, rtol=1e-5)
    assert float(torch.cat([g[1] for g in grads], 2)[0, :, 48:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# spawn 1: the (2, 2), (1, 4) and (4, 1) meshes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Inputs and the one-device/JAX references; then the 4-rank spawn."""
    tmp = tmp_path_factory.mktemp("parity")
    jcfg = jd.DiTConfig(**TINY)
    dit_np = init_dit_numpy(td.DiTConfig(**TINY), seed=0)
    rng = np.random.default_rng(0)
    fwd = (rng.standard_normal((4, 32, 20)).astype(np.float32), rng.standard_normal((4, 32, 20)).astype(np.float32),
           rng.integers(0, 30, (4, 12)).astype(np.int32), rng.uniform(size=(4,)).astype(np.float32))

    loss_jcfg = jcfm.CFMConfig(model=dataclasses.replace(jcfg, dropout=0.0))
    mel = np.random.default_rng(1).standard_normal((4, 32, 20)).astype(np.float32)
    text = np.random.default_rng(1).integers(0, 30, (4, 12)).astype(np.int32)
    lens = np.array([32, 30, 32, 25], np.int32)
    key = jax.random.PRNGKey(2)

    trainers = trainer_cfgs()
    train_np = init_dit_numpy(td.DiTConfig(**TRAIN), seed=3)
    mmdit_cfg = MMDiTConfig(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, mel_dim=20, text_num_embeds=30,
                            text_max_pos=64)
    mmdit_cfgs = (tcfm.CFMConfig(model=mmdit_cfg), TrainConfig(learning_rate=1e-3, warmup_updates=0,
                                                                total_updates=10, grad_clip=0.05))
    ref_audio = (0.1 * np.sin(np.arange(24000) / 9.0)).astype(np.float32)
    engine = {"dit_cfg": td.DiTConfig(**ENGINE_DIT), "dit_np": init_dit_numpy(td.DiTConfig(**ENGINE_DIT), seed=4),
              "voc_np": init_vocos_numpy(VocosConfig(**VOC), seed=5), "vocab": VOCAB,
              "cfg": EngineConfig(mel=MelConfig(n_mels=20), vocoder=VocosConfig(**VOC), compute_dtype="float32",
                                  sampler=serving_default_sampler(steps=2)),
              "text": "Hello tensor parallel world.", "ref": ref_audio, "ref_text": "Hello."}
    rng8 = np.random.default_rng(9)
    int8_linear = {"w": rng8.standard_normal((128, 64)).astype(np.float32) * 0.05,
                   "b": rng8.standard_normal((64,)).astype(np.float32),
                   "x": rng8.standard_normal((3, 10, 128)).astype(np.float32)}
    int8_linear["x"][0, 0, 70] = 25.0  # this row's abs-max sits on model rank 2's K-shard alone
    b8, n8 = 2, 128
    engine_int8 = {**engine, "cfg": dataclasses.replace(engine["cfg"], quantization="int8"),
                   "program": (rng8.standard_normal((b8, n8, 20)).astype(np.float32), np.array([30, 45], np.int32),
                               np.where(np.arange(40)[None] < np.array([[40], [25]]),
                                        rng8.integers(0, 90, (b8, 40)), -1).astype(np.int32),
                               np.array([128, 100], np.int32)),
                   "y0": rng8.standard_normal((b8, n8, 20)).astype(np.float32)}
    ucfg = dict(TINY, depth=2)
    unett_np = init_unett_numpy(UNetTConfig(**ucfg), seed=8)
    inputs = {"tiny": td.DiTConfig(**TINY), "dit_np": dit_np, "fwd_batch": fwd,
              "unett": (UNetTConfig(**ucfg), unett_np),
              "loss_cfg": tcfm.CFMConfig(model=td.DiTConfig(**TINY, dropout=0.0)),
              "loss_batch": (mel, text, lens), "loss_draws": jax_draws(key, 4, 32, 20, loss_jcfg),
              "trainers": trainers, "train_np": train_np, "train_batches": train_batches(10),
              "adafactor_batches": adafactor_batches(), "engine": engine, "int8_linear": int8_linear,
              "engine_int8": engine_int8,
              "mmdit": {"cfgs": mmdit_cfgs, "np": init_mmdit_numpy(mmdit_cfg, seed=6),
                        "batch": train_batches(13, count=1)[0]}}
    run = start_spawn(dryrun.parity_worker, inputs, tmp, "parity")

    f = jnp.zeros((4,), bool)
    j = {"fwd": np.asarray(jd.dit_forward(dit_np, jcfg, *(jnp.asarray(a) for a in fwd), f, f)),
         "unett": np.asarray(ju.unett_forward(unett_np, ju.UNetTConfig(**ucfg), *(jnp.asarray(a) for a in fwd), f, f))}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jcfm.cfm_loss(p, loss_jcfg, key, jnp.asarray(mel), jnp.asarray(text), jnp.asarray(lens)),
        has_aux=True))(dit_np)
    j.update(loss=float(jloss), masked_frames=int(jaux["masked_frames"]), grads=flat(np_tree(jgrads)))

    mm_np = inputs["mmdit"]["np"]
    j_mmcfg = jmm.MMDiTConfig(**{k: getattr(mmdit_cfg, k) for k in ("dim", "depth", "heads", "dim_head", "ff_mult",
                                                                      "mel_dim", "text_num_embeds", "text_max_pos")})
    j["mmdit_fwd"] = np.asarray(jax.jit(lambda p, *a: jmm.mmdit_forward(p, j_mmcfg, *a, f, f))(
        mm_np, *(jnp.asarray(a) for a in fwd)))
    mm_loss_cfg = jcfm.CFMConfig(model=j_mmcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jcfm.cfm_loss(p, mm_loss_cfg, key, jnp.asarray(mel), jnp.asarray(text), jnp.asarray(lens)),
        has_aux=True))(mm_np)
    j.update(mmdit_loss=float(jl), mmdit_grads=flat(np_tree(jg)))

    jq = jm.quantize_linear_params({"w": jnp.asarray(int8_linear["w"]), "b": jnp.asarray(int8_linear["b"])})
    j["int8_linear"] = np.asarray(jm._linear_int8(jq, jnp.asarray(int8_linear["x"])))
    j["int8_engine"] = jax_int8_program(engine_int8)
    return {"inputs": inputs, "outs": run(), "jax": j, "tmp": tmp}


def jax_int8_program(e):
    """The JAX int8 engine's program on one device with explicit noise
    (``tests/test_torch_quant.py``'s): the generated mel and the wave."""
    voc = jv.VocosConfig(**VOC)
    sampler = je.serving_default_sampler(steps=2)
    eng = j_engine.TTSEngine(e["dit_np"], jd.DiTConfig(**ENGINE_DIT), e["voc_np"], JTokenizer(VOCAB),
                             j_engine.EngineConfig(mel=JMelConfig(n_mels=20), vocoder=voc, sampler=sampler,
                                                   compute_dtype="float32", quantization="int8"))
    n = e["y0"].shape[1]

    @jax.jit
    def program(dp, vp, cond, cond_lens, text, duration, y0):
        mel_out = je.sample_cfm(dp, eng.dit_cfg, cond=cond, cond_lens=cond_lens, text=text, duration=duration,
                                sampler=sampler, y0=y0)
        idx = (jnp.arange(n)[None, :] + cond_lens[:, None]) % n
        gen = jnp.take_along_axis(mel_out, idx[..., None], axis=1)
        gen = jnp.where(jnp.arange(n)[None, :, None] < (duration - cond_lens)[:, None, None], gen, 0.0)
        return gen, jv.vocos_decode(vp, gen, voc)

    gen, wave = program(eng.dit_params, eng.vocos_params, *(jnp.asarray(a) for a in (*e["program"], e["y0"])))
    return np.asarray(gen), np.asarray(wave)


def one_device_train(inputs, opt: str, batches):
    model_cfg, train_cfg = inputs["trainers"][opt]
    trainer = Trainer(model_cfg, train_cfg, compute_dtype=torch.float32, device="cpu")
    state = init_train_state(model_cfg, train_cfg, "cpu", inputs["train_np"])
    metrics = [{k: float(v) for k, v in trainer.step(state, b).items()} for b in batches]
    return metrics, state


@pytest.mark.parametrize("mesh", ["fwd_22", "fwd_14", "unett_22"])
def test_tp_forward_matches_jax(parity, mesh):
    """The DiT at (2, 2) and at one head per model rank (1, 4): head-0 RoPE on
    model rank 0 only; the UNetT at (2, 2)."""
    ref = parity["jax"]["unett" if mesh == "unett_22" else "fwd"]
    for out in parity["outs"]:
        np.testing.assert_allclose(out[mesh], ref, atol=2e-4, rtol=1e-4)


def test_dp_tp_loss_and_gradients_match_jax(parity):
    j = parity["jax"]
    for out in parity["outs"]:
        assert abs(out["loss"] - j["loss"]) < 1e-4
        assert out["masked_frames"] == j["masked_frames"]  # the global count
        got = flat(out["grads"])
        assert set(got) == set(j["grads"])
        for name, ref in j["grads"].items():
            assert rel_l2(got[name], ref) < 2e-2, name


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_trainer_step_under_the_mesh_matches_one_device(parity, opt):
    inputs = parity["inputs"]
    batches = inputs["train_batches"] if opt == "adamw" else inputs["adafactor_batches"]
    metrics, state = one_device_train(inputs, opt, batches)
    assert metrics[0]["grad_norm"] > 5 * inputs["trainers"][opt][1].grad_clip  # the clip bites
    parts = ("params", "opt_state", "ema")
    want = host_flat({k: state[k] for k in parts})
    for out in parity["outs"]:
        got = out[f"train_{opt}"]
        for m_got, m_ref in zip(got["metrics"], metrics):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(m_got[k], m_ref[k], rtol=1e-5)
        got_flat = host_flat({k: got["state"][k] for k in parts})
        assert set(got_flat) == set(want)
        lr = inputs["trainers"][opt][1].learning_rate
        for name, w in want.items():
            if opt == "adafactor" and name.endswith("to_k/b"):
                # the key bias's gradient is zero up to rounding (the softmax ignores a per-row shift of the
                # scores) and Adafactor has no eps to damp it: each update is rounding noise scaled to ~lr
                np.testing.assert_allclose(got_flat[name], w, atol=4 * lr, rtol=0, err_msg=name)
            else:
                np.testing.assert_allclose(got_flat[name], w, rtol=1e-5, atol=STEP_ATOL, err_msg=name)


def test_tp_checkpoint_loads_on_one_device(parity):
    out0 = parity["outs"][0]
    assert all(o["ckpt"]["step"] == 1 and o["ckpt"]["reshards_equal"] for o in parity["outs"])
    step, state = restore_latest(str(parity["tmp"] / "ckpt"), "cpu")
    assert step == 1
    want = flat(out0["ckpt"]["whole"])
    got = {k: v.detach().numpy() for k, v in tree_leaves(state["params"])}
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    model_cfg, train_cfg = parity["inputs"]["trainers"]["adamw"]
    _, ref_state = one_device_train(parity["inputs"], "adamw", parity["inputs"]["train_batches"][:1])
    for k, v in tree_leaves(ref_state["params"]):  # the whole tree is the one-device step's
        np.testing.assert_allclose(got[k], v.detach().numpy(), rtol=1e-5, atol=STEP_ATOL, err_msg=k)
    x = torch.as_tensor(parity["inputs"]["fwd_batch"][0])
    f = torch.zeros((4,), dtype=torch.bool)
    with torch.no_grad():
        y = td.dit_forward(state["params"], model_cfg.model, x, x, torch.zeros((4, 8), dtype=torch.int32),
                           torch.full((4,), 0.5), f, f)
    assert y.shape == x.shape and torch.isfinite(y).all()


def test_engine_under_tp_matches_mesh_free(parity):
    e = parity["inputs"]["engine"]
    engine = TTSEngine(e["dit_np"], e["dit_cfg"], e["voc_np"], Tokenizer(e["vocab"]), e["cfg"], device="cpu")
    ref = engine.synthesize(e["text"], e["ref"], 24000, e["ref_text"], seed=7)[0]
    waves = [o["wave"] for o in parity["outs"]]
    assert all(np.array_equal(w, waves[0]) for w in waves)  # every rank returns the same wave
    np.testing.assert_allclose(waves[0], ref, atol=1e-5 * float(np.abs(ref).max()), rtol=0)


def test_mmdit_trains_data_parallel(parity):
    inputs = parity["inputs"]["mmdit"]
    model_cfg, train_cfg = inputs["cfgs"]
    trainer = Trainer(model_cfg, train_cfg, compute_dtype=torch.float32, device="cpu")
    state = init_train_state(model_cfg, train_cfg, "cpu", inputs["np"])
    loss = float(trainer.step(state, inputs["batch"])["loss"])
    for out in parity["outs"]:
        np.testing.assert_allclose(out["mmdit"]["loss"], loss, rtol=1e-5)
        got = flat(out["mmdit"]["params"])
        for k, v in tree_leaves(state["params"]):
            np.testing.assert_allclose(got[k], v.detach().numpy(), rtol=1e-5, atol=STEP_ATOL, err_msg=k)


def test_mmdit_tp_forward_matches_jax(parity):
    """The MMDiT at (2, 2): 2 heads a rank, global head 0's flat RoPE on model
    rank 0 for both streams, ``to_out_c`` column-parallel between its two
    gathers."""
    for out in parity["outs"]:
        np.testing.assert_allclose(out["mmdit_fwd_22"], parity["jax"]["mmdit_fwd"], atol=2e-4, rtol=1e-4)


def test_mmdit_dp_tp_loss_and_gradients_match_jax(parity):
    j = parity["jax"]
    for out in parity["outs"]:
        assert abs(out["mmdit_loss_22"] - j["mmdit_loss"]) < 1e-4
        got = flat(out["mmdit_grads_22"])
        assert set(got) == set(j["mmdit_grads"])
        for name, ref in j["mmdit_grads"].items():
            assert rel_l2(got[name], ref) < 2e-2, name


def test_mmdit_trainer_step_under_tp_matches_one_device(parity):
    inputs = parity["inputs"]["mmdit"]
    model_cfg, train_cfg = inputs["cfgs"]
    trainer = Trainer(model_cfg, train_cfg, compute_dtype=torch.float32, device="cpu")
    state = init_train_state(model_cfg, train_cfg, "cpu", inputs["np"])
    loss = float(trainer.step(state, inputs["batch"])["loss"])
    for out in parity["outs"]:
        np.testing.assert_allclose(out["mmdit_22"]["loss"], loss, rtol=1e-5)
        got = flat(out["mmdit_22"]["params"])
        for k, v in tree_leaves(state["params"]):
            np.testing.assert_allclose(got[k], v.detach().numpy(), rtol=1e-5, atol=STEP_ATOL, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_parallel_int8_linear_is_bit_equal_to_one_device(parity, dtype):
    """At (1, 4): each rank's K-shard with the whole weight's column scales,
    the row abs-max all-reduced (row 0's lives on one shard: a shard-local
    abs-max would quantize that row differently on the other three), the
    int32 sums all-reduced: bit-equal to the one-device ``_linear_int8``, and
    in fp32 within 1e-6 of the JAX ``_linear_int8``."""
    lin = parity["inputs"]["int8_linear"]
    tdt = getattr(torch, dtype)
    w, b, x = (torch.as_tensor(lin[k]).to(tdt) for k in ("w", "b", "x"))
    q = tm.quantize_linear_params({"w": w, "b": b})
    ref = tm._linear_int8(q, x).float().numpy()
    shard = q["w_q"].shape[0] // 4
    for r, out in enumerate(parity["outs"]):
        got = out["int8_linear"][dtype]
        np.testing.assert_array_equal(got["y"], ref)
        np.testing.assert_array_equal(got["s_w"], q["s_w"].numpy())
        np.testing.assert_array_equal(got["w_q"], q["w_q"][r * shard:(r + 1) * shard].numpy())
    if dtype == "float32":
        np.testing.assert_allclose(ref, parity["jax"]["int8_linear"], rtol=1e-6, atol=1e-6)
    row = x[0, 0].float().abs()  # the other ranks' shards of row 0 peak below the row's abs-max
    assert int(row.argmax()) == 70 and all(float(row[r * 32:(r + 1) * 32].max()) < float(row.max()) for r in (0, 1, 3))


def test_int8_engine_under_tp_is_bit_equal_to_one_device(parity):
    """``TTSEngine(quantization="int8", mesh=(2, 2))``: sharded, then
    quantized; its bucket program with explicit noise gives the one-device
    int8 engine's mel and wave bit for bit, and agrees with the JAX int8
    engine within ``tests/test_torch_quant.py``'s 1e-3 relative L2."""
    e = parity["inputs"]["engine_int8"]
    engine = TTSEngine(e["dit_np"], e["dit_cfg"], e["voc_np"], Tokenizer(e["vocab"]), e["cfg"], device="cpu")
    with torch.no_grad():
        gen, wave = engine.bucket_program(*(torch.as_tensor(a) for a in e["program"]), steps=2, cfg_strength=2.0,
                                          y0=torch.as_tensor(e["y0"]))
    for out in parity["outs"]:
        np.testing.assert_array_equal(out["int8_engine"]["gen"], gen.numpy())
        np.testing.assert_array_equal(out["int8_engine"]["wave"], wave.numpy())
    j_gen, j_wave = parity["jax"]["int8_engine"]
    assert rel_l2(gen.numpy(), j_gen) < 1e-3 and rel_l2(wave.numpy(), j_wave) < 1e-3


def test_train_cli_model_parallel(parity):
    assert all(o["cli"] == {"step": 3, "finite": True} for o in parity["outs"])


# ---------------------------------------------------------------------------
# spawn 2: context parallel (cp 4) and the dry run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    rng = np.random.default_rng(0)
    b, h, n, d = 2, 2, 64, 16
    qkv = [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3)]
    mask = np.ones((b, n), bool)
    mask[0, 40:] = False  # row 0: the last rank's 16 keys all masked
    mask[1, 50:] = False
    cfg = jd.DiTConfig(**RING_DIT)
    params = init_dit_numpy(td.DiTConfig(**RING_DIT), seed=0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 20)).astype(np.float32)
    text = rng.integers(0, 30, (2, 16)).astype(np.int32)
    t = np.array([0.3, 0.7], np.float32)
    fmask = np.arange(64)[None, :] < np.array([64, 48])[:, None]
    upstream = rng.standard_normal((b, h, n, d)).astype(np.float32)
    target = rng.standard_normal((2, 64, 20)).astype(np.float32)
    inputs = {"qkv": qkv, "mask": mask, "upstream": upstream,
              "fwd": {"cfg": td.DiTConfig(**RING_DIT), "np": params, "inputs": (x, text, t, fmask), "target": target}}
    run = start_spawn(dryrun.ring_worker, inputs, tmp, "ring")
    q, k, v = (jnp.asarray(a) for a in qkv)
    f = jnp.zeros((2,), bool)
    ref = {"ring": np.asarray(sdpa_xla(q, k, v, None)), "ring_masked": np.asarray(sdpa_xla(q, k, v, jnp.asarray(mask))),
           "dit": np.asarray(jd.dit_forward(params, cfg, jnp.asarray(x), jnp.asarray(x), jnp.asarray(text),
                                            jnp.asarray(t), f, f, jnp.asarray(fmask)))}
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("cp",))
    g = jnp.asarray(upstream)
    ring_grad = jax.jit(jax.grad(lambda q_, k_, v_, m: jnp.sum(j_ring_attention(q_, k_, v_, m, mesh=mesh) * g),
                                 argnums=(0, 1, 2)))
    for name, m in (("ring_grads", None), ("ring_masked_grads", jnp.asarray(mask))):
        ref[name] = [np.asarray(a) for a in ring_grad(q, k, v, m)]
    ring_cfg = dataclasses.replace(cfg, attn_impl="ring")
    jfm = jnp.asarray(fmask)

    def dit_loss(p):
        y = jd.dit_forward(p, ring_cfg, jnp.asarray(x), jnp.asarray(x), jnp.asarray(text), jnp.asarray(t), f, f, jfm)
        return jnp.sum(y * jnp.asarray(target) * jfm[..., None])

    with jax.sharding.set_mesh(mesh):
        ref["dit_ring_grads"] = flat(np_tree(jax.jit(jax.grad(dit_loss))(jax.tree.map(jnp.asarray, params))))
    return {"inputs": inputs, "outs": run(), "ref": ref}


@pytest.mark.parametrize("with_mask", [False, True])
def test_ring_attention_matches_sdpa(ring, with_mask):
    name = "ring_masked" if with_mask else "ring"
    valid = ring["inputs"]["mask"] if with_mask else np.ones((2, 64), bool)
    assert not valid[0, 48:].any() or not with_mask  # one shard of row 0 wholly masked
    for out in ring["outs"]:
        for bi in range(2):
            np.testing.assert_allclose(out[name][bi, :, valid[bi]], ring["ref"][name][bi, :, valid[bi]],
                                       atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("with_mask", [False, True])
def test_ring_attention_gradients_match_jax(ring, with_mask):
    """dq, dk, dv of ``sum(ring_attention(q, k, v) * g)`` against ``jax.grad``
    through the JAX ring on a cp-4 CPU mesh; with the mask, row 0's last
    shard is wholly masked (its keys' dk and dv are zero)."""
    name = "ring_masked_grads" if with_mask else "ring_grads"
    for out in ring["outs"]:
        for got, ref in zip(out[name], ring["ref"][name]):
            np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    if with_mask:
        assert float(np.abs(ring["outs"][0][name][1][0, :, 48:]).max()) == 0.0


def test_ring_dit_training_gradients_match_jax(ring):
    """The gradient of a fixed linear loss over the valid frames of the ring
    DiT (``training=True``: checkpointed blocks, the ring's forward run again
    in the recompute) with the parameters as leaves, against ``jax.grad`` of
    the JAX ring DiT under ``jax.sharding.set_mesh``."""
    ref = ring["ref"]["dit_ring_grads"]
    for out in ring["outs"]:
        got = flat(out["dit_ring_grads"])
        assert set(got) == set(ref)
        for name, want in ref.items():
            assert rel_l2(got[name], want) < 1e-4, name


def test_dit_forward_with_ring_attention(ring):
    valid = ring["inputs"]["fwd"]["inputs"][3]
    for out in ring["outs"]:
        for bi in range(2):
            np.testing.assert_allclose(out["dit_ring"][bi][valid[bi]], ring["ref"]["dit"][bi][valid[bi]],
                                       atol=3e-4, rtol=1e-3)


def test_dryrun_multichip_counterpart_runs(ring):
    runs = [o["dryrun"] for o in ring["outs"]]
    assert all(r["mesh"] == (2, 2) and np.isfinite(r["loss"]) for r in runs)
    assert len({r["loss"] for r in runs}) == 1 and len({r["serve_mel_rms"] for r in runs}) == 1
