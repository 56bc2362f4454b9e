"""Flow-matching trainer (counterpart of ``f5tts_tpu/train/trainer.py``),
on one device or over a ``(data, model)`` mesh.

The optimizers follow optax's semantics, written out over the params tree:
- the schedule (linear warmup 0 -> lr, then linear decay to 0) is read at the
  optimizer's update count *before* it is incremented, so the first update
  uses ``schedule(0) = 0`` (a ``LambdaLR`` stepping after the update would be
  one step ahead);
- ``clip_by_global_norm``: ``g / norm * max_norm`` when ``norm >= max_norm``,
  with no ``+ 1e-6`` in the denominator (``clip_grad_norm_`` adds one);
- AdamW (``optimizer="adamw"``): Adam moments with bias correction, ``eps``
  added to ``sqrt(v_hat)``, decoupled weight decay on every leaf,
  ``p += -lr * update``;
- Adafactor (``optimizer="adafactor"``, the chain ``optax.adafactor`` builds
  with the JAX trainer's arguments): second moments factored into row and
  column means for leaves with two dims >= 128 (full for the others), decay
  ``1 - (count + 1) ** -0.999``, each leaf's update clipped to RMS 1, scaled
  by the learning rate, a bf16 momentum of 0.9 without bias correction (its
  decay applied as optax applies it: 0.9 rounded to bf16), then
  ``weight_decay * p`` added (not scaled by the learning rate, as in optax).
Gradient accumulation averages micro-batch gradients with their weights (0
for the empty micro-batches that pad a trailing group). The EMA updates after
each step. Params, moments and EMA are fp32 (Adafactor's momentum bf16); the
forward runs in ``compute_dtype``. The optimizer updates the tensors in
place. ``Trainer(sample_hook=..., sample_every=...)`` synthesizes samples
every ``sample_every`` (default ``save_every``) updates.

Under a mesh (``Trainer(mesh=...)``, ``parallel/mesh.py``), one process per
device: every rank reads the same global batch and keeps its rows
(``local_batch_slice``; with accumulation, the rows of each micro-batch),
draws the global batch's randoms from the shared generator and keeps its
rows, and holds its Megatron shards of the params, moments and EMA
(``state_shardings``). The step is the one-device step on the global batch:
- the loss's denominator is global (``cfm_loss(mesh=...)``) and the
  gradients are summed over ``data``; tensor-parallel partial gradients are
  summed over ``model`` inside the backward, at the input of each
  column-parallel linear;
- the global-norm clip counts every element once: a sharded leaf's squares
  are summed over ``model``, a replicated leaf's taken once;
- Adafactor's factored row and column means and its per-leaf RMS clip span
  the whole leaf (an ``all_reduce`` over ``model`` along a sharded axis), so
  Adafactor under TP is Adafactor on one device; AdamW and the EMA are
  elementwise on the shards;
- checkpoints are saved whole (unsharded, written by rank 0) and sharded
  again on restore, so a tensor-parallel run's checkpoint loads on one
  device; the sample hook runs on rank 0 from the whole state.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from f5tts_tpu_torch.models.cfm import CFMConfig, cfm_draws, cfm_loss
from f5tts_tpu_torch.parallel.sharding import (dit_param_specs, map_with_specs, shard_tensor, sharded_axis,
                                               unshard_params)
from f5tts_tpu_torch.train.ema import EMAConfig, ema_init, ema_update
from f5tts_tpu_torch.train.tree import tree_leaves, tree_map
from f5tts_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 7.5e-5
    warmup_updates: int = 20_000
    total_updates: int = 1_200_000
    grad_clip: float = 1.0
    weight_decay: float = 0.01
    max_grad_accum: int = 1
    ema: EMAConfig = field(default_factory=EMAConfig)
    seed: int = 0
    # "adafactor": factored second moments and a bf16 momentum in place of
    # AdamW's two fp32 moments (the JAX trainer's stand-in for the
    # reference's 8-bit AdamW, ``bnb_optimizer``)
    optimizer: str = "adamw"  # "adamw" | "adafactor"

    def __post_init__(self):
        if self.optimizer not in ("adamw", "adafactor"):
            raise ValueError(f"optimizer must be 'adamw' or 'adafactor', got {self.optimizer!r}")


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adamw's (the JAX trainer's) values


def lr_schedule(cfg: TrainConfig):
    """``count -> lr`` (fp32): linear warmup 0 -> lr over ``warmup_updates``,
    then linear decay lr -> 0 until ``total_updates`` (optax's
    ``join_schedules`` of two ``linear_schedule``s)."""
    decay_steps = max(cfg.total_updates - cfg.warmup_updates, 1)

    def linear(init: float, end: float, steps: int, count: int) -> np.float32:
        if steps <= 0:
            return np.float32(init)
        frac = np.float32(1.0) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)

    def schedule(count: int) -> np.float32:
        if count < cfg.warmup_updates:
            return linear(0.0, cfg.learning_rate, cfg.warmup_updates, count)
        return linear(cfg.learning_rate, 0.0, decay_steps, count - cfg.warmup_updates)

    return schedule


def global_norm(tensors, specs: list | None = None, tp=None) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together. Under ``tp`` (with each
    tensor's spec), the squares of sharded tensors are summed over the model
    group and replicated ones counted once: every element of the whole tree
    once."""
    if tp is None or tp.size == 1:
        return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))
    sq = [torch.sum(torch.square(t.float())) for t in tensors]
    shard = [x for x, s in zip(sq, specs) if sharded_axis(s) is not None]
    whole = [x for x, s in zip(sq, specs) if sharded_axis(s) is None]
    return torch.sqrt(sum(whole) + tp.all_reduce(sum(shard)))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float, specs: list | None = None,
                        tp=None) -> list[torch.Tensor]:
    """optax's ``clip_by_global_norm``: ``g / norm * max_norm`` when ``norm >= max_norm``."""
    norm = global_norm(grads, specs, tp)
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


@torch.no_grad()
def adamw_apply(params, grads: list[torch.Tensor], opt_state: dict, lr, weight_decay: float) -> None:
    """One AdamW update of the params tree at learning rate ``lr`` (the
    schedule's value at ``opt_state["count"]``), in place; advances the count."""
    count = opt_state["count"] + 1
    bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** np.float32(count))
    leaves = tree_leaves(params)
    for (_, p), g, (_, mu), (_, nu) in zip(leaves, grads, tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])):
        mu.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
        nu.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        update.add_(p, alpha=weight_decay)
        p.add_(update, alpha=-float(lr))
    opt_state["count"] = count


# optax.adafactor as the JAX trainer configures it
ADAFACTOR_MIN_DIM, ADAFACTOR_DECAY, ADAFACTOR_MOMENTUM, ADAFACTOR_EPS = 128, 0.999, 0.9, 1e-30
ADAFACTOR_MOMENTUM_BF16 = float(torch.tensor(ADAFACTOR_MOMENTUM).to(torch.bfloat16))  # 0.8984375


def factored_dims(shape) -> tuple[int, int] | None:
    """The two largest axes a leaf's second moment is factored over (optax's
    rule: the second largest at least ``ADAFACTOR_MIN_DIM``), or None."""
    shape = tuple(int(d) for d in shape)
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def adafactor_init(params) -> dict:
    """Adafactor state: per leaf the row and column second moments (factored
    leaves) or the full one, the bf16 momentum, and the update count."""

    def zeros(t, shape):
        return torch.zeros(tuple(int(d) for d in shape), dtype=t.dtype, device=t.device)

    def v_row(t):
        dims = factored_dims(t.shape)
        return zeros(t, np.delete(t.shape, dims[1]) if dims else (1,))

    def v_col(t):
        dims = factored_dims(t.shape)
        return zeros(t, np.delete(t.shape, dims[0]) if dims else (1,))

    def v(t):
        return zeros(t, (1,) if factored_dims(t.shape) else t.shape)

    return {"v_row": tree_map(v_row, params), "v_col": tree_map(v_col, params), "v": tree_map(v, params),
            "momentum": tree_map(lambda t: torch.zeros_like(t, dtype=torch.bfloat16), params), "count": 0}


def _whole_mean(x: torch.Tensor, dim: int | None, sharded: int | None, size: int, tp, keepdim: bool = False):
    """``x.mean(dim)`` (``dim`` None: over every element) of the whole leaf
    when ``x`` is one rank's block along axis ``sharded`` of ``size`` blocks:
    a sum over the model group where the mean crosses the sharded axis."""
    if sharded is None or (dim is not None and dim != sharded):
        return x.mean() if dim is None else x.mean(dim, keepdim=keepdim)
    total = x.sum() if dim is None else x.sum(dim, keepdim=keepdim)
    return tp.all_reduce(total) / ((x.numel() if dim is None else x.shape[dim]) * size)


@torch.no_grad()
def adafactor_apply(params, grads: list[torch.Tensor], opt_state: dict, lr, weight_decay: float,
                    specs: list | None = None, tp=None) -> None:
    """One Adafactor update of the params tree at learning rate ``lr``, in
    place; advances the count. Under ``tp`` (with each leaf's spec) the
    factoring follows the whole leaf's shape and its means span the whole
    leaf."""
    t = np.float32(opt_state["count"] + 1)
    decay = float(np.float32(1.0) - t ** np.float32(-ADAFACTOR_DECAY))
    keep = float(np.float32(1.0) - np.float32(decay))
    size = tp.size if tp is not None else 1
    state_leaves = [tree_leaves(opt_state[k]) for k in ("v_row", "v_col", "v", "momentum")]
    for i, ((_, p), g, (_, vr), (_, vc), (_, v), (_, mom)) in enumerate(zip(tree_leaves(params), grads,
                                                                          *state_leaves)):
        g2 = g * g + ADAFACTOR_EPS
        ax = sharded_axis(specs[i]) if specs is not None and size > 1 else None
        shape = [d * size if a == ax else d for a, d in enumerate(p.shape)]
        dims = factored_dims(shape)
        if dims is not None:
            d1, d0 = dims
            vr.mul_(decay).add_(_whole_mean(g2, d0, ax, size, tp) * keep)
            vc.mul_(decay).add_(_whole_mean(g2, d1, ax, size, tp) * keep)
            in_vr = d1 - 1 if d1 > d0 else d1  # axis d1 of the leaf in v_row (axis d0 removed)
            ax_vr = None if ax in (None, d0) else (ax - 1 if ax > d0 else ax)
            row_col_mean = _whole_mean(vr, in_vr, ax_vr, size, tp, keepdim=True)
            update = g * torch.rsqrt(vr / row_col_mean).unsqueeze(d0) * torch.rsqrt(vc).unsqueeze(d1)
        else:
            v.mul_(decay).add_(g2 * keep)
            update = g * torch.rsqrt(v)
        rms = torch.sqrt(_whole_mean(update * update, None, ax, size, tp))
        update = update / torch.clamp_min(rms, 1.0)  # clip_by_block_rms(1)
        update = update * float(lr)
        # optax's ``0.9 * accumulator`` takes the weakly typed 0.9 in the accumulator's bf16 (0.8984375);
        # jitted, the product and the sum stay fp32
        update = (1 - ADAFACTOR_MOMENTUM) * update + ADAFACTOR_MOMENTUM_BF16 * mom.float()
        mom.copy_(update)
        p.sub_(update + weight_decay * p)
    opt_state["count"] = opt_state["count"] + 1


def init_opt_state(params, optimizer: str = "adamw") -> dict:
    if optimizer == "adafactor":
        return adafactor_init(params)
    return {"mu": tree_map(torch.zeros_like, params), "nu": tree_map(torch.zeros_like, params), "count": 0}


@torch.no_grad()
def optimizer_update(params, grads: list[torch.Tensor], opt_state: dict, optimizer: str, lr, weight_decay: float,
                     clip: float, specs: list | None = None, tp=None) -> None:
    """Clip ``grads`` (which follow ``tree_leaves(params)``) by their global
    norm, then one ``optimizer`` ("adamw" or "adafactor") update of the params
    tree at learning rate ``lr``, all in place. ``specs``/``tp``: the leaves
    are this rank's shards (see the module docstring)."""
    grads = clip_by_global_norm(grads, clip, specs, tp)
    if optimizer == "adafactor":
        adafactor_apply(params, grads, opt_state, lr, weight_decay, specs, tp)
    else:
        adamw_apply(params, grads, opt_state, lr, weight_decay)


def optimizer_state_bytes(opt_state: dict) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(opt_state) if isinstance(t, torch.Tensor))


def init_train_state(model_cfg: CFMConfig, train_cfg: TrainConfig, device, params_np: dict | None = None) -> dict:
    """Fresh train state: fp32 params (a copy of ``params_np``, e.g. JAX params
    as numpy, or the backbone's seeded numpy init) that require grad, zeroed
    optimizer state, an EMA copy, step 0."""
    from f5tts_tpu_torch.models import backbone_fns
    from f5tts_tpu_torch.models.convert import params_from_numpy

    tree = params_np if params_np is not None else backbone_fns(model_cfg.model)[0](model_cfg.model, seed=train_cfg.seed)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params_from_numpy(tree, device, torch.float32))
    return {
        "params": params,
        "opt_state": init_opt_state(params, train_cfg.optimizer),
        "ema": ema_init(params),
        "step": 0,
    }


def state_shardings(state: dict) -> dict:
    """The spec tree of a train state (counterpart of the JAX
    ``state_shardings``): the params' specs (``dit_param_specs``) for the
    params, AdamW's moments, Adafactor's momentum and full second moments,
    and the EMA; Adafactor's factored row (column) moments take their
    leaf's spec without its factored column (row) axis; the step and counts
    are not sharded. Call it on the whole state: the factoring follows the
    whole leaf's shape."""
    specs = dit_param_specs(state["params"])
    opt = state["opt_state"]
    if "mu" in opt:
        opt_specs = {"mu": specs, "nu": specs, "count": ()}
    else:
        def factored(spec, t, drop: int):
            dims = factored_dims(t.shape)
            if dims is None or sharded_axis(spec) is None:
                return ()
            full = list(spec) + [None] * (t.ndim - len(spec))
            del full[dims[drop]]
            return tuple(full) if "model" in full else ()

        leaves = [(s, t) for s, (_, t) in zip(_spec_leaves(specs), tree_leaves(state["params"]))]
        flat = {"v_row": [factored(s, t, 1) for s, t in leaves], "v_col": [factored(s, t, 0) for s, t in leaves],
                "v": [() if factored_dims(t.shape) else s for s, t in leaves]}
        opt_specs = {k: _unflatten(state["params"], v) for k, v in flat.items()}
        opt_specs.update(momentum=specs, count=())
    return {"params": specs, "opt_state": opt_specs, "ema": specs, "step": ()}


def _spec_leaves(specs) -> list:
    """The specs in ``tree_leaves`` order."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    return [] if specs is None else [specs]


def _unflatten(tree, flat: list):
    """``flat`` (one entry per tensor leaf, ``tree_leaves`` order) in ``tree``'s structure."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def shard_state(state: dict, mesh, specs: dict | None = None) -> dict:
    """This rank's shards of a whole train state (params keep
    ``requires_grad``); ``specs`` from ``state_shardings`` of it."""
    axis = mesh["model"]
    specs = specs if specs is not None else state_shardings(state)
    return map_with_specs(lambda t, s: shard_tensor(t, s, axis.size, axis.index), state, specs)


def unshard_state(state: dict, mesh, specs: dict) -> dict:
    """The whole train state on every rank from its shards (collective);
    ``specs`` from ``state_shardings`` of the whole state."""
    return {k: (unshard_params(v, mesh, specs[k]) if isinstance(v, dict) else v) for k, v in state.items()}


def _micro_batches(batch: dict) -> list[tuple]:
    """``(mel, text, lens, weight)`` per micro-batch: one for a plain batch,
    ``accum`` for a batch with a leading accumulation axis."""
    if batch["mel"].ndim == 3:
        return [(batch["mel"], batch["text"], batch["lens"], 1.0)]
    weights = batch.get("micro_weight")
    weights = [1.0] * batch["mel"].shape[0] if weights is None else [float(w) for w in weights]
    return [(batch["mel"][i], batch["text"][i], batch["lens"][i], weights[i]) for i in range(len(weights))]


def train_step(state: dict, batch: dict, draws: list, model_cfg: CFMConfig, train_cfg: TrainConfig,
               compute_dtype: torch.dtype = torch.bfloat16, mesh=None) -> dict:
    """One optimizer update on ``batch`` (tensors on the params' device, with
    an optional leading accumulation axis and ``micro_weight``); ``draws``
    holds one ``CFMDraws`` per micro-batch. Updates ``state`` in place and
    returns the step's metrics as 0-d tensors (loss and aux averaged over the
    weighted micro-batches, the pre-clip gradient norm). Under ``mesh`` the
    batch and draws are this rank's rows and the state its shards; the
    metrics are global."""
    params = state["params"]
    leaves = [t for _, t in tree_leaves(params)]
    for t in leaves:
        t.grad = None
    micro = _micro_batches(batch)
    wsum = max(sum(w for *_, w in micro), 1.0)
    loss_sum, aux_sum = 0.0, {}
    for (mel, text, lens, w), d in zip(micro, draws):
        if w == 0.0:  # an empty pad micro-batch: weight 0 in every average
            continue
        loss, aux = cfm_loss(params, model_cfg, d, mel, text, lens, compute_dtype, mesh=mesh)
        (loss * (w / wsum)).backward()
        loss_sum = loss_sum + w * loss.detach()
        for k, v in aux.items():
            aux_sum[k] = aux_sum.get(k, 0.0) + w * v.detach().float()
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
    specs = tp = None
    if mesh is not None:
        data, tp = mesh["data"], mesh["model"]
        specs = _spec_leaves(dit_param_specs(params))
        if data.size > 1:  # each rank's share of the global loss: its gradients and loss sum to the global ones
            flat = data.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
            grads = [f.view_as(g) for f, g in zip(torch.split(flat, [g.numel() for g in grads]), grads)]
            loss_sum = data.all_reduce(torch.as_tensor(loss_sum, dtype=torch.float32, device=flat.device))
    gnorm = global_norm(grads, specs, tp)
    opt_state = state["opt_state"]
    optimizer_update(params, grads, opt_state, train_cfg.optimizer, lr_schedule(train_cfg)(opt_state["count"]),
                     train_cfg.weight_decay, train_cfg.grad_clip, specs, tp)
    for t in leaves:
        t.grad = None
    state["step"] += 1
    ema_update(state["ema"], params, state["step"], train_cfg.ema)
    return {"loss": loss_sum / wsum, "grad_norm": gnorm, **{k: v / wsum for k, v in aux_sum.items()}}


def group_micro_batches(batches, accum: int):
    """Stack ``accum`` consecutive micro-batches along a leading axis, padding
    each to the group's max (rows, frames, text); padded rows carry lens 0. A
    trailing partial group is padded with empty (weight-0) micro-batches and
    carries ``micro_weight``, so nothing is dropped."""
    group = []

    def emit(group):
        real = len(group)
        if real < accum:
            empty = {
                "mel": group[0]["mel"][:1] * 0.0,
                "text": np.full_like(group[0]["text"][:1], -1),
                "lens": np.zeros_like(group[0]["lens"][:1]),
            }
            group = group + [empty] * (accum - real)
        mb = max(x["mel"].shape[0] for x in group)
        mn = max(x["mel"].shape[1] for x in group)
        mt = max(x["text"].shape[1] for x in group)
        return {
            "mel": np.stack([np.pad(x["mel"], ((0, mb - x["mel"].shape[0]), (0, mn - x["mel"].shape[1]), (0, 0)))
                             for x in group]),
            "text": np.stack([np.pad(x["text"], ((0, mb - x["text"].shape[0]), (0, mt - x["text"].shape[1])),
                                     constant_values=-1) for x in group]),
            "lens": np.stack([np.pad(x["lens"], (0, mb - x["lens"].shape[0])) for x in group]),
            "micro_weight": (np.arange(accum) < real).astype(np.float32),
        }

    for b in batches:
        group.append(b)
        if len(group) == accum:
            yield emit(group)
            group = []
    if group:
        yield emit(group)


class Trainer:
    """Host-side training loop on one device or over a mesh: numpy batches
    in, metrics and checkpoints out. ``mesh`` (``parallel/mesh.py``): every
    rank runs the same calls on the same global batches (SPMD); the state
    it returns and takes holds this rank's shards."""

    def __init__(self, model_cfg: CFMConfig, train_cfg: TrainConfig = TrainConfig(),
                 compute_dtype: torch.dtype = torch.bfloat16, checkpoint_dir: str | None = None,
                 log_every: int = 50, save_every: int = 10_000, logger=None, device=None,
                 sample_hook=None, sample_every: int | None = None, mesh=None):
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.compute_dtype = compute_dtype
        self.checkpoint_dir = checkpoint_dir
        self.log_every = log_every
        self.save_every = save_every
        self.logger = logger
        self.sample_hook = sample_hook  # callable(state, step): periodic sample synthesis
        self.sample_every = sample_every  # the hook's cadence; None = save_every
        self.mesh = mesh
        if mesh is not None and device is not None and resolve_device(device).type != mesh.device.type:
            raise ValueError(f"device {device!r} differs from the mesh's {mesh.device}")
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(train_cfg.seed + 1)
        self._specs = None  # state_shardings of the whole state, set when a state is sharded

    @property
    def lead(self) -> bool:
        """Whether this process logs and writes (rank 0 of the mesh, or no mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def init_or_resume(self) -> tuple[dict, int]:
        """A fresh state (params from the backbone's numpy init with the config's
        seed), or the newest readable checkpoint's (a torn newest step falls
        back to the previous one); under a mesh, this rank's shards of it."""
        state, step = None, 0
        if self.checkpoint_dir:
            from f5tts_tpu_torch.train.checkpoint import restore_latest

            found, restored = restore_latest(self.checkpoint_dir, self.device)
            if found is not None:
                restored["params"] = tree_map(lambda t: t.requires_grad_(True), restored["params"])
                state, step = restored, int(found)
        if state is None:
            state = init_train_state(self.model_cfg, self.train_cfg, self.device)
        return self.shard(state), step

    def shard(self, state: dict) -> dict:
        """This rank's shards of a whole state (the state itself without a mesh)."""
        if self.mesh is None:
            return state
        self._specs = state_shardings(state)
        return shard_state(state, self.mesh, self._specs)

    def whole(self, state: dict) -> dict:
        """The whole state from this rank's shards (collective under a mesh)."""
        if self.mesh is None:
            return state
        return unshard_state(state, self.mesh, self._specs)

    def _local_rows(self, batch: dict) -> dict:
        """This rank's rows of a global numpy batch (of each micro-batch)."""
        if self.mesh is None:
            return batch
        from f5tts_tpu_torch.parallel.launcher import local_batch_slice

        axis = batch["mel"].ndim - 3  # 1 with a leading accumulation axis
        sl = local_batch_slice(batch["mel"].shape[axis], self.mesh)
        rows = (slice(None),) * axis + (sl,)
        return {**batch, **{k: batch[k][rows] for k in ("mel", "text", "lens")}}

    def _to_device(self, batch: dict) -> dict:
        out = {k: torch.as_tensor(batch[k], device=self.device) for k in ("mel", "text", "lens")}
        if "micro_weight" in batch:
            out["micro_weight"] = batch["micro_weight"]
        return out

    def step(self, state: dict, batch: dict) -> dict:
        """One update on a numpy batch, with draws from the trainer's
        generator: under a mesh ``batch`` is the global batch, and the draws
        are made for it and cut to this rank's rows."""
        mel_dim = self.model_cfg.model.mel_dim
        draws = [cfm_draws(self.generator, torch.as_tensor(lens), mel.shape[1], mel_dim, self.model_cfg)
                 for mel, _, lens, _ in _micro_batches(batch)]
        local = self._local_rows(batch)
        if self.mesh is not None:
            from f5tts_tpu_torch.parallel.launcher import local_batch_slice

            sl = local_batch_slice(len(draws[0].t), self.mesh)
            draws = [d.rows(sl) for d in draws]
        return train_step(state, self._to_device(local), draws, self.model_cfg, self.train_cfg, self.compute_dtype,
                          mesh=self.mesh)

    def fit(self, state: dict, batches, total_updates: int | None = None) -> dict:
        """Train on an iterator of numpy batches (``mel``, ``text``, ``lens``);
        with ``max_grad_accum > 1`` consecutive batches form one update. The
        step counter is kept on the host; the log reads the loss only on
        logging steps. Under a mesh, rank 0 logs, saves the whole state and
        runs the sample hook on it."""
        if self.train_cfg.max_grad_accum > 1:
            batches = group_micro_batches(batches, self.train_cfg.max_grad_accum)
        t0 = time.perf_counter()
        frames_done = 0
        base_step = int(state["step"])
        for i, batch in enumerate(batches):
            if total_updates is not None and i >= total_updates:
                break
            metrics = self.step(state, batch)
            frames_done += int(np.sum(batch["lens"]))
            step_no = base_step + i + 1
            if self.logger and self.lead and step_no % self.log_every == 0:
                self.logger(step=step_no, loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                            frames_per_s=frames_done / max(time.perf_counter() - t0, 1e-9))
            save = self.checkpoint_dir and step_no % self.save_every == 0
            sample = self.sample_hook and step_no % (self.sample_every or self.save_every) == 0
            whole = self.whole(state) if save or sample else None
            if save and self.lead:
                from f5tts_tpu_torch.train.checkpoint import save_state

                save_state(self.checkpoint_dir, step_no, whole)
            if save and self.mesh is not None and self.mesh.world > 1:  # no rank reads a step before it is written
                import torch.distributed as dist

                dist.barrier()
            if sample and self.lead:
                self.sample_hook(whole, step_no)
        return state
