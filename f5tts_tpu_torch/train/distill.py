"""Step distillation: compress the guided ODE solve into a few-step student
(counterpart of ``f5tts_tpu/train/distill.py``).

F5-TTS serves ``NFE x 2`` transformer forwards (the CFG pair on every eval);
the reference recipe spends 64. A student whose velocity field already
includes guidance, and whose K-step Euler rollout reproduces the teacher's
fine guided solve, serves at K forwards.

Method (trajectory distillation with rollout-state targets), as in the JAX
package:

- Teacher: the frozen base weights. Its guided velocity is
  ``v_g(t, y) = cond + s * (cond - null)``, one fused 2b-row forward (or, with
  ``teacher_single_branch``, one b-row conditioned forward: a teacher that is
  itself a distilled student).
- Student: same architecture, initialized as a copy of the teacher's tensors,
  run with both branches conditioned (no drop flags): ONE forward per eval.
- Each step rolls the student (no grad) through its own K-step trajectory from
  fresh noise; at every visited state ``y_k`` the student's velocity is
  regressed against ``(T_m(y_k, t_k -> t_{k+1}) - y_k) / dt``, ``T_m`` an
  m-substep guided Ralston solve of the interval by the teacher.

What changes in torch:

- The rollout and the teacher solves run under ``torch.no_grad()`` through
  ``dit_forward(training=False)``: the serving kernels. The student's
  gradient forward is ``dit_forward(training=True)`` over K*b rows (or
  ``loss_chunk``*b rows a chunk) with the key mask and no dropout: the
  training kernels and the conv-pos pair's masked differentiable route.
- ``loss_chunk`` is a Python loop that calls ``.backward()`` per chunk (the
  JAX step scans ``value_and_grad`` over the chunks and sums the grads); the
  denominator stays global, the adaptive normalisation chunk-local.
- The optimizer is the global-norm clip then AdamW (optax's ``adamw`` at a
  constant lr, or at ``cosine_decay_schedule(lr, lr_decay_steps, alpha=0.01)``
  read at the update count), written out by ``train/trainer.py``.
- Noise comes from the port's ``sample_noise_from_seeds`` (``jax.random``
  cannot be reproduced); parity tests replace this module's name.
- ``make_distill_step``'s step updates the student's tensors and the
  optimizer state in place; ``stage`` (optional) is called at each stage's
  end (``"rollout"``, ``"teacher"``, ``"student"``, ``"update"``), which is
  where a caller reads its timers and launch counters.

Cost per training step at batch b: K student rollout forwards (b rows),
2*K*m teacher forwards (2b rows, or b with a single-branch teacher), and one
student gradient forward (K*b rows). The student serves through the engine
with ``student_sampler``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from f5tts_tpu_torch.models.dit import DiTConfig, dit_embed, dit_forward
from f5tts_tpu_torch.ops.masks import lens_to_mask
from f5tts_tpu_torch.sampling.euler import SamplerConfig, sample_noise_from_seeds, sway_time_grid
from f5tts_tpu_torch.train.trainer import global_norm, init_opt_state, optimizer_update
from f5tts_tpu_torch.train.tree import tree_leaves, tree_map
from f5tts_tpu_torch.utils.device import resolve_device, to_device


@dataclass(frozen=True)
class DistillConfig:
    student_steps: int = 8  # K: Euler intervals the student serves at
    substeps: int = 4  # m: teacher Ralston substeps per student interval
    cfg_strength: float = 2.0  # guidance baked into the student
    sway_sampling_coef: float | None = -1.0  # student knot grid warp
    learning_rate: float = 1e-4
    lr_decay_steps: int | None = None  # cosine decay to lr/100 over this many steps
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    seed: int = 0
    # the teacher is a distilled student (guidance in its weights): one
    # conditioned forward per eval, no CFG pair (progressive distillation)
    teacher_single_branch: bool = False
    # "none": uniform MSE over the K knots; "adaptive": each knot's
    # contribution normalized by its own (no-grad) error scale
    knot_weighting: str = "none"
    # knots per gradient chunk of the K-fold loss forward (0 = all K at once);
    # must divide student_steps
    loss_chunk: int = 0

    @property
    def time_grid(self) -> tuple[float, ...]:
        g = np.linspace(0.0, 1.0, self.student_steps + 1)
        if self.sway_sampling_coef is not None:
            g = g + self.sway_sampling_coef * (np.cos(np.pi / 2 * g) - 1 + g)
        g[0], g[-1] = 0.0, 1.0  # exact endpoints (float cos() dust breaks validation)
        return tuple(float(v) for v in g)


def student_sampler(cfg: DistillConfig) -> SamplerConfig:
    """The sampler that serves a distilled student: plain Euler on the
    student's knot grid with guidance off (it is in the weights); K forwards
    in all (no CFG pair)."""
    return SamplerConfig(steps=cfg.student_steps, cfg_strength=0.0, sway_sampling_coef=None, method="euler",
                         time_grid=cfg.time_grid)


def deepen_student(teacher_params, model_cfg: DiTConfig, factor: int = 2):
    """Capacity-sweep student init: ``factor - 1`` identity copies after each
    teacher block (their adaLN-zero modulation projection zeroed, so every
    gate is 0 and the block passes x through). Returns ``(params,
    deeper_cfg)``; the leaves outside the blocks are the teacher's tensors."""
    depth = model_cfg.depth
    params = dict(teacher_params)
    blocks = tree_map(lambda x: x.repeat_interleave(factor, dim=0), params["blocks"])
    keep = torch.as_tensor((np.arange(depth * factor) % factor) == 0)  # False at the inserted copies

    def zero_new(x):
        return x * keep.to(x.device, x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))

    blocks["attn_norm"]["linear"] = tree_map(zero_new, blocks["attn_norm"]["linear"])
    params["blocks"] = blocks
    return params, dataclasses.replace(model_cfg, depth=depth * factor)


def cosine_decay_lr(init_value: float, decay_steps: int, alpha: float = 0.01):
    """``count -> lr`` (fp32) of ``optax.cosine_decay_schedule(init_value,
    decay_steps, alpha)``."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> np.float32:
        c = np.float32(min(count, decay_steps))
        cosine = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(np.pi) * c / np.float32(decay_steps)))
        return np.float32(init_value) * (np.float32(1 - alpha) * cosine + np.float32(alpha))

    return schedule


class DistillOptimizer:
    """The distillation optimizer: ``clip_by_global_norm(grad_clip)`` then
    AdamW at the config's learning rate (constant, or the cosine decay)."""

    def __init__(self, cfg: DistillConfig):
        self.cfg = cfg
        lr = cfg.learning_rate
        self.lr_at = cosine_decay_lr(lr, cfg.lr_decay_steps) if cfg.lr_decay_steps else (lambda count: lr)

    def init(self, params) -> dict:
        return init_opt_state(params, "adamw")

    def update(self, params, grads: list[torch.Tensor], opt_state: dict) -> None:
        optimizer_update(params, grads, opt_state, "adamw", self.lr_at(opt_state["count"]), self.cfg.weight_decay,
                         self.cfg.grad_clip)


def _batch_tensors(batch: dict, device) -> dict:
    return {k: v if isinstance(v, torch.Tensor) and v.device == device else to_device(torch.as_tensor(v), device)
            for k, v in batch.items()}


def make_distill_step(model_cfg: DiTConfig, cfg: DistillConfig, compute_dtype: torch.dtype = torch.float32):
    """Returns ``(optimizer, step)``: ``step(student, opt_state, teacher,
    batch, stage=None) -> metrics`` updates the student's tensors and
    ``opt_state`` in place and returns ``{"loss", "grad_norm"}`` (0-d tensors;
    the gradient norm before the clip).

    ``batch``: ``cond (b, n, mel)``, ``cond_lens (b,)``, ``text (b, nt)``,
    ``duration (b,)``, ``seeds (b,)``: the prompts ``sample_cfm`` takes
    (numpy or tensors; moved to the student's device). The step's two halves
    are ``step.targets`` and ``step.gradients`` (see ``DistillStep``)."""
    step = DistillStep(model_cfg, cfg, compute_dtype)
    return step.optimizer, step


class DistillStep:
    """One distillation step, in two halves a caller may also run apart:
    ``targets`` (no grad: the student's rollout states and the teacher's
    interval targets) and ``gradients`` (the student's loss and gradients on
    those states and targets; they may come from a step of another compute
    dtype or impl, since the forward casts its inputs to this step's)."""

    def __init__(self, model_cfg: DiTConfig, cfg: DistillConfig, compute_dtype: torch.dtype = torch.float32):
        if cfg.knot_weighting not in ("none", "adaptive"):
            raise ValueError(f"knot_weighting must be 'none' or 'adaptive', got {cfg.knot_weighting!r}")
        self.model_cfg, self.cfg, self.cd = model_cfg, cfg, compute_dtype
        self.optimizer = DistillOptimizer(cfg)
        self.K, self.m = cfg.student_steps, cfg.substeps
        self.kc = cfg.loss_chunk or self.K
        if self.K % self.kc != 0:
            raise ValueError(f"loss_chunk {self.kc} must divide student_steps {self.K}")
        self.knots = torch.tensor(cfg.time_grid, dtype=torch.float32)

    def __call__(self, student, opt_state, teacher, batch, stage: Callable[[str], None] | None = None) -> dict:
        ctx = self.targets(student, teacher, batch, stage)
        loss, grads = self.gradients(student, ctx)
        gnorm = global_norm(grads)
        if stage:
            stage("student")
        self.optimizer.update(student, grads, opt_state)
        if stage:
            stage("update")
        return {"loss": loss, "grad_norm": gnorm}

    def _prompts(self, batch: dict, dev) -> dict:
        cd = self.cd
        batch = _batch_tensors(batch, dev)
        cond, cond_lens, text = batch["cond"], batch["cond_lens"], batch["text"]
        n = cond.shape[1]
        lens = torch.maximum((text != -1).sum(-1), cond_lens)
        cond_mask = lens_to_mask(lens, n)
        duration = torch.clamp(torch.maximum(lens + 1, batch["duration"]), max=n)
        attn_mask = lens_to_mask(duration, n)
        return {
            "text": text, "duration": duration, "seeds": batch["seeds"], "attn_mask": attn_mask,
            "step_cond": torch.where(cond_mask[..., None], cond.to(cd), torch.zeros((), dtype=cd, device=dev)),
            "gen_mask": (attn_mask & ~cond_mask)[..., None],
            # knots in compute dtype: the rollout's dt and the teacher's substep grid round as in the JAX step
            "knots": self.knots.to(dev).to(cd),
        }

    def _student_vel(self, params, ctx, emb_b, t_vec, y, rep: int, training: bool = False):
        emb = emb_b.repeat(rep, 1, 1) if rep > 1 else emb_b
        no_drop = torch.zeros((y.shape[0],), dtype=torch.bool, device=y.device)
        return dit_forward(params, self.model_cfg, y, ctx["step_cond"].repeat(rep, 1, 1), None, t_vec.to(self.cd),
                           no_drop, no_drop, ctx["attn_mask"].repeat(rep, 1), emb, compute_dtype=self.cd,
                           training=training)

    @torch.no_grad()
    def targets(self, student, teacher, batch, stage: Callable[[str], None] | None = None) -> dict:
        """The prompts' tensors, the student's rollout states ``states (K, b,
        n, mel)`` from fresh noise and the teacher's interval targets
        ``targets (K, b, n, mel)``, in the compute dtype."""
        model_cfg, cd, K, m, s = self.model_cfg, self.cd, self.K, self.m, self.cfg.cfg_strength
        dev = tree_leaves(student)[0][1].device
        ctx = self._prompts(batch, dev)
        text, attn_mask, step_cond, knots_c = ctx["text"], ctx["attn_mask"], ctx["step_cond"], ctx["knots"]
        b, n, mel_dim = step_cond.shape
        sub_grid = sway_time_grid(m, None, dtype=cd, device=dev)  # linspace(0, 1, m + 1) in cd
        f = torch.zeros((b,), dtype=torch.bool, device=dev)
        if self.cfg.teacher_single_branch:
            t_emb1 = dit_embed(teacher, model_cfg, text, n, f, attn_mask)

            def teacher_vel(t_scalar, y):
                return dit_forward(teacher, model_cfg, y, step_cond, None, t_scalar.expand(b).to(cd), f, f,
                                   attn_mask, text_emb=t_emb1, compute_dtype=cd)
        else:
            # the guided velocity: one fused 2b forward (cond; null)
            drop2 = torch.cat([f, ~f])
            mask2 = torch.cat([attn_mask, attn_mask])
            t_emb2 = dit_embed(teacher, model_cfg, torch.cat([text, text]), n, drop2, mask2)
            cond2 = torch.cat([step_cond, step_cond])

            def teacher_vel(t_scalar, y):
                out = dit_forward(teacher, model_cfg, torch.cat([y, y]), cond2, None,
                                  t_scalar.expand(2 * b).to(cd), drop2, drop2, mask2, text_emb=t_emb2,
                                  compute_dtype=cd)
                pred, null = out[:b], out[b:]
                return pred + (pred - null) * s

        y = sample_noise_from_seeds(ctx["seeds"], n, mel_dim, ctx["duration"], cd)

        # 1) student rollout: the state y_k at every knot
        emb_sg = dit_embed(student, model_cfg, text, n, f, attn_mask)
        states = []
        for k in range(K):
            states.append(y)
            t0, t1 = knots_c[k], knots_c[k + 1]
            y = y + (t1 - t0) * self._student_vel(student, ctx, emb_sg, t0.expand(b), y, 1)
        ctx["states"] = torch.stack(states)
        if stage:
            stage("rollout")

        # 2) the teacher's fine Ralston solve of each interval from the rollout state
        targets = []
        for k in range(K):
            t0, t1 = knots_c[k], knots_c[k + 1]
            sub = t0 + (t1 - t0) * sub_grid
            y_k = y = states[k]
            for j in range(m):
                a, c = sub[j], sub[j + 1]
                dt_ = c - a
                k1 = teacher_vel(a, y)
                k2 = teacher_vel(a + (2.0 / 3.0) * dt_, y + (2.0 / 3.0) * dt_ * k1)
                y = y + dt_ * (0.25 * k1 + 0.75 * k2)
            targets.append((y - y_k) / (t1 - t0))
        ctx["targets"] = torch.stack(targets)
        if stage:
            stage("teacher")
        return ctx

    def gradients(self, student, ctx: dict) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """``(loss, grads)`` of the student's gradient forward over the K knots
        (K*b rows, or ``loss_chunk``*b rows a chunk) on ``ctx``'s states and
        targets. ``grads`` follow ``tree_leaves(student)``; no ``.grad`` is
        left set. The denominator sums ALL K knots' masks, so the chunked sum
        equals the single-shot loss."""
        K, kc = self.K, self.kc
        leaves = [t for _, t in tree_leaves(student)]
        text, attn_mask, knots_c, states = ctx["text"], ctx["attn_mask"], ctx["knots"], ctx["states"]
        _, b, n, mel_dim = states.shape
        f = torch.zeros((b,), dtype=torch.bool, device=states.device)
        for t in leaves:
            t.grad = None
        gen_w = ctx["gen_mask"].float()
        denom = torch.clamp_min(K * gen_w.sum() * mel_dim, 1.0)
        loss_sum = torch.zeros((), dtype=torch.float32, device=states.device)
        for c0 in range(0, K, kc):
            t_vec = knots_c[c0 : c0 + kc].repeat_interleave(b)
            y_flat = states[c0 : c0 + kc].reshape(kc * b, n, mel_dim)
            emb = dit_embed(student, self.model_cfg, text, n, f, attn_mask)
            pred = self._student_vel(student, ctx, emb, t_vec, y_flat, kc, training=True)
            err = pred.float() - ctx["targets"][c0 : c0 + kc].reshape(kc * b, n, mel_dim).float()
            w = gen_w.repeat(kc, 1, 1)
            sq = torch.square(err) * w
            if self.cfg.knot_weighting == "adaptive":
                # each knot's MSE normalized by its own (no-grad) magnitude, over this chunk's knots
                per_knot = (sq.reshape(kc, b, n, mel_dim).sum((1, 2, 3))
                            / torch.clamp_min(w.sum() / kc * mel_dim, 1.0))
                scale = (1.0 / torch.clamp_min(per_knot, 1e-8)).detach()
                scale = scale / scale.mean()
                sq = sq.reshape(kc, b, n, mel_dim) * scale[:, None, None, None]
            loss = sq.sum() / denom
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
        for t in leaves:
            t.grad = None
        return loss_sum, grads


def copy_params(params, device):
    """A copy of a params tree (tensors or numpy) on ``device``, sharing no
    storage with it, that requires grad."""
    return tree_map(lambda t: torch.as_tensor(t).to(device).detach().clone().requires_grad_(True), params)


def distill(teacher_params, model_cfg: DiTConfig, cfg: DistillConfig, prompt_fn, steps: int,
            compute_dtype: torch.dtype = torch.float32, log_every: int = 25, logger=print, device=None):
    """Run distillation: ``prompt_fn(rng) -> batch`` supplies serving-shaped
    prompts (cond / cond_lens / text / duration / seeds as numpy) from a
    ``np.random.default_rng(cfg.seed)``. The teacher (tensors or a numpy
    tree) is used on ``device`` (``cuda`` unless ``"cpu"`` is asked for);
    the student starts as a copy of its tensors. Returns the student's
    params (detached)."""
    dev = resolve_device(device)
    teacher = tree_map(lambda t: torch.as_tensor(t).to(dev), teacher_params)
    optimizer, step = make_distill_step(model_cfg, cfg, compute_dtype)
    student = copy_params(teacher, dev)
    opt_state = optimizer.init(student)
    rng = np.random.default_rng(cfg.seed)
    for i in range(steps):
        metrics = step(student, opt_state, teacher, prompt_fn(rng))
        if logger and (i % log_every == 0 or i == steps - 1):
            logger(f"  distill step {i}: loss {float(metrics['loss']):.5f} gnorm {float(metrics['grad_norm']):.3f}")
    return tree_map(lambda t: t.detach(), student)
