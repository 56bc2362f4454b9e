"""Context-parallel ring attention over the mel-frame axis (counterpart of
``f5tts_tpu/parallel/ring_attention.py``).

For sequences past the 4096-frame bucket: each of the ``p`` ranks of the
``cp`` axis keeps its block of queries, and the key/value blocks (with their
key-mask block) travel one hop a step around the ring, so every rank sees
every block in ``p`` hops. Attention is bidirectional, so no hop is skipped.

The per-shard body (``ring_body``, the counterpart of ``_ring_body``) is
apart from its transport: ``RingTransport`` rotates the blocks over the
``cp`` group with ``batch_isend_irecv`` (the next block's transfer runs under
the current hop's product), and ``LocalTransport`` hands a one-process
caller the blocks in the order the ring would, so the card can check the
body, forward and backward, without a second device.

Each hop is the training forward attention kernel,
``flash_attention_train_fwd`` (kernel 3a: ``(o, lse)``, the scores stay on
chip), or its plain version on the CPU. The hops are merged by their
log-sum-exps in fp32 (``merge_hop``), where the JAX body keeps an online
softmax over raw scores (``m``, ``l``, ``acc``): the same sum, regrouped. A
hop whose keys are all masked returns ``lse = -1e30``, which gives it weight
``exp(-1e30 - m) = 0`` beside any hop with a valid key; a row with no valid
key at all weighs its (equal) hops alike and so averages every value, as the
JAX body and ``sdpa`` do.

``ring_attention`` is differentiable (``jax.grad`` goes through the JAX
ring, plain jnp code under ``shard_map``). The forward keeps the merged
output and its fp32 log-sum-exp ``m + log(s)``; the backward
(``ring_body_bwd``) runs the training backward kernel (kernel 3b,
``flash_attention_train_bwd``) once per hop on the hop's k/v/mask block with
the merged ``o`` and ``lse``: against the global lse each hop's dQ, dK and dV
are exact terms of the whole backward. dQ accumulates in fp32 on this rank;
the fp32 dK/dV accumulators travel around the ring with their block and take
one more rotation home. The gradients are gathered over ``cp`` as the output
is, so every rank holds them whole and parameter gradients agree across the
ring with no further all-reduce. Rows with no valid key keep the forward's
behaviour (their ``dO`` is zero in the DiT).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from f5tts_tpu_torch.ops.kernels.flash_attention_train import (flash_attention_train_bwd, flash_attention_train_fwd,
                                                                readable)
from f5tts_tpu_torch.parallel.mesh import Axis


def merge_hop(acc, o, lse):
    """Fold one hop's ``(o, lse)`` into the running ``(o, m, s)`` (fp32; None
    before the first hop): ``o`` the merged output so far, ``m`` the largest
    lse so far and ``s`` the hops' summed ``exp(lse - m)``, kept apart so that
    rows whose every lse is -1e30 (no valid key yet) count their hops."""
    o = o.float()
    if acc is None:
        return o, lse, torch.ones_like(lse)
    o_acc, m_acc, s_acc = acc
    m = torch.maximum(m_acc, lse)
    w_acc, w = s_acc * torch.exp(m_acc - m), torch.exp(lse - m)
    s = w_acc + w
    return o_acc * (w_acc / s)[..., None] + o * (w / s)[..., None], m, s


def ring_forward(q, k, v, key_mask, p: int, rotate):
    """``(o, lse)`` of this rank's queries against ``p`` key blocks: this
    rank's own ``k``/``v``/``key_mask`` block first, then each block
    ``rotate`` hands over. ``o`` is the merged output in ``q``'s dtype, ``lse``
    its fp32 log-sum-exp ``m + log(s)`` ``(b, h, n/p)``. ``rotate(k, v,
    key_mask)`` starts the move to the next hop and returns a callable that
    waits for it and returns the next ``(k, v, key_mask)``."""
    acc = None
    for hop in range(p):
        pending = rotate(k, v, key_mask) if hop < p - 1 else None
        acc = merge_hop(acc, *flash_attention_train_fwd(q, k, v, key_mask))
        if pending is not None:
            k, v, key_mask = pending()
    o, m, s = acc
    return o.to(q.dtype), m + torch.log(s)


def ring_body(q, k, v, key_mask, p: int, rotate):
    """``(b, h, n/p, d)`` output of this rank's queries (``ring_forward``'s
    ``o``)."""
    return ring_forward(q, k, v, key_mask, p, rotate)[0]


def ring_body_bwd(q, k, v, key_mask, o, lse, do, p: int, transport):
    """fp32 ``(dq, dk, dv)`` of this rank's blocks from its rows ``do`` of the
    upstream gradient, the forward's merged ``o`` and ``lse``: kernel 3b once
    per hop, in the forward's hop order. dq accumulates here; the dK/dV
    accumulators of each block travel with it (``transport.grads`` gives this
    rank's own at hop 0, ``transport.pass_grads`` sends them on after a hop
    and returns the previous rank's), so after ``p`` hops this rank holds its
    own block's whole dk and dv."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = transport.grads(k, v)
    for hop in range(p):
        pending = transport(k, v, key_mask) if hop < p - 1 else None
        gq, gk, gv = flash_attention_train_bwd(q, k, v, o, lse, do, key_mask)
        dq.add_(gq)
        dk.add_(gk)
        dv.add_(gv)
        dk, dv = transport.pass_grads(dk, dv)()
        if pending is not None:
            k, v, key_mask = pending()
    return dq, dk, dv


def _bool_as(t):
    return t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()


class RingTransport:
    """Rotation over the ``cp`` group: send this block to the next rank,
    receive the previous rank's (as ``lax.ppermute`` with ``i -> i + 1``).
    Calling it rotates ``(k, v, key_mask)`` (the key mask travels as uint8;
    None stays None); ``grads`` are fresh fp32 zeros and ``pass_grads``
    rotates the dK/dV accumulators the same way."""

    def __init__(self, cp: Axis):
        self.cp = cp

    def _rotate(self, tensors):
        cp = self.cp
        out = [_bool_as(t) for t in tensors if t is not None]
        into = [torch.empty_like(t) for t in out]
        ops = [dist.P2POp(dist.isend, t, cp.peer(1), cp.group) for t in out]
        ops += [dist.P2POp(dist.irecv, t, cp.peer(-1), cp.group) for t in into]
        reqs = dist.batch_isend_irecv(ops)

        def wait():
            for r in reqs:
                r.wait()
            got = iter(into)
            return tuple(None if t is None else (next(got).bool() if t.dtype == torch.bool else next(got))
                         for t in tensors)

        return wait

    def __call__(self, k, v, key_mask):
        return self._rotate((k, v, key_mask))

    def grads(self, k, v):
        return (torch.zeros(k.shape, dtype=torch.float32, device=k.device),
                torch.zeros(v.shape, dtype=torch.float32, device=v.device))

    def pass_grads(self, dk, dv):
        return self._rotate((dk, dv))


class LocalTransport:
    """The rotation rank ``rank`` of a ``len(blocks)``-rank ring sees, from
    every block held in one process: at hop ``i`` it holds block ``rank -
    i``. For the backward, ``grads`` (a dict shared by the ranks' transports)
    holds each block's fp32 dK/dV accumulators: run the ranks one after
    another with one dict, and each rank's returned dk/dv (the dict's tensors
    for its block, added to in place) hold every rank's terms once all
    have run."""

    def __init__(self, blocks: list[tuple], rank: int, grads: dict | None = None):
        self.blocks, self.rank, self.p = blocks, rank, len(blocks)
        self.shared = {} if grads is None else grads
        self.hop = self.grad_hop = 0

    def __call__(self, k, v, key_mask):
        self.hop += 1
        nxt = self.blocks[(self.rank - self.hop) % self.p]
        return lambda: nxt

    def _block_grads(self, j: int):
        if j not in self.shared:
            k, v, _ = self.blocks[j]
            self.shared[j] = (torch.zeros(k.shape, dtype=torch.float32, device=k.device),
                              torch.zeros(v.shape, dtype=torch.float32, device=v.device))
        return self.shared[j]

    def grads(self, k, v):
        return self._block_grads(self.rank % self.p)

    def pass_grads(self, dk, dv):
        self.grad_hop += 1
        nxt = self._block_grads((self.rank - self.grad_hop) % self.p)
        return lambda: nxt


def seq_blocks(t, p: int, dim: int) -> list[torch.Tensor]:
    """``t`` cut into ``p`` equal blocks along ``dim`` (views)."""
    if t.shape[dim] % p:
        raise ValueError(f"sequence of {t.shape[dim]} frames does not divide over {p} context-parallel ranks")
    return list(torch.chunk(t, p, dim))


class _RingAttention(torch.autograd.Function):
    """The ring's forward (``ring_forward``) and backward (``ring_body_bwd``)
    over ``RingTransport``; both gather their results over ``cp``."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, cp: Axis):
        p, r = cp.size, cp.index
        qb, kb, vb = (seq_blocks(t, p, 2)[r] for t in (q, k, v))
        mb = seq_blocks(key_mask, p, 1)[r] if key_mask is not None else None
        o, lse = ring_forward(qb, kb, vb, mb, p, RingTransport(cp))
        ctx.cp = cp
        ctx.save_for_backward(qb, kb, vb, mb, o, lse)
        return cp.all_gather(o, 2)

    @staticmethod
    def backward(ctx, do):
        cp = ctx.cp
        qb, kb, vb, mb, o, lse = ctx.saved_tensors
        dob = seq_blocks(do, cp.size, 2)[cp.index]
        if dob.is_cuda and not readable(dob):  # e.g. an expanded gradient
            dob = dob.contiguous()
        dq, dk, dv = ring_body_bwd(qb, kb, vb, mb, o, lse, dob, cp.size, RingTransport(cp))
        return (cp.all_gather(dq.to(qb.dtype), 2), cp.all_gather(dk.to(kb.dtype), 2),
                cp.all_gather(dv.to(vb.dtype), 2), None, None)


def ring_attention(q, k, v, key_mask, cp: Axis):
    """Ring attention with the JAX signature: ``(b, h, n, d)`` q/k/v and the
    ``(b, n)`` key mask (or None) as every rank of ``cp`` holds them; this
    rank computes its block of queries around the ring and the blocks are
    gathered back to ``(b, h, n, d)`` on every rank (what ``shard_map`` under
    an ambient mesh gives the DiT). Differentiable: the gradients of q, k and
    v come back whole on every rank. ``n`` must divide over the ring."""
    return _RingAttention.apply(q, k, v, key_mask, cp)
