"""Context-parallel ring attention over the mel-frame axis (counterpart of
``f5tts_tpu/parallel/ring_attention.py``).

For sequences past the 4096-frame bucket: each of the ``p`` ranks of the
``cp`` axis keeps its block of queries, and the key/value blocks (with their
key-mask block) travel one hop a step around the ring, so every rank sees
every block in ``p`` hops. Attention is bidirectional, so no hop is skipped.

The per-shard body (``ring_body``, the counterpart of ``_ring_body``) is
apart from its transport: ``ring_transport`` rotates the blocks over the
``cp`` group with ``batch_isend_irecv`` (the next block's transfer runs under
the current hop's product), and ``local_transport`` hands a one-process
caller the blocks in the order the ring would, so the card can check the
body without a second device.

Each hop is the training forward attention kernel,
``flash_attention_train_fwd`` (kernel 3a: ``(o, lse)``, the scores stay on
chip), or its plain version on the CPU. The hops are merged by their
log-sum-exps in fp32 (``merge_hop``), where the JAX body keeps an online
softmax over raw scores (``m``, ``l``, ``acc``): the same sum, regrouped. A
hop whose keys are all masked returns ``lse = -1e30``, which gives it weight
``exp(-1e30 - m) = 0`` beside any hop with a valid key; a row with no valid
key at all weighs its (equal) hops alike and so averages every value, as the
JAX body and ``sdpa`` do. The ring is forward-only: the training path raises
on ``attn_impl="ring"``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from f5tts_tpu_torch.ops.kernels.flash_attention_train import flash_attention_train_fwd
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


def ring_body(q, k, v, key_mask, p: int, rotate):
    """``(b, h, n/p, d)`` output of this rank's queries against ``p`` key
    blocks: this rank's own ``k``/``v``/``key_mask`` block first, then each
    block ``rotate`` hands over. ``rotate(k, v, key_mask)`` starts the move
    to the next hop and returns a callable that waits for it and returns the
    next ``(k, v, key_mask)``."""
    acc = None
    for hop in range(p):
        pending = rotate(k, v, key_mask) if hop < p - 1 else None
        acc = merge_hop(acc, *flash_attention_train_fwd(q, k, v, key_mask))
        if pending is not None:
            k, v, key_mask = pending()
    return acc[0].to(q.dtype)


def ring_transport(cp: Axis):
    """Rotation over the ``cp`` group: send this block to the next rank,
    receive the previous rank's (as ``lax.ppermute`` with ``i -> i + 1``).
    The key mask travels as uint8."""

    def rotate(k, v, key_mask):
        out = [k.contiguous(), v.contiguous()] + ([key_mask.to(torch.uint8)] if key_mask is not None else [])
        into = [torch.empty_like(t) for t in out]
        ops = [dist.P2POp(dist.isend, t, cp.peer(1), cp.group) for t in out]
        ops += [dist.P2POp(dist.irecv, t, cp.peer(-1), cp.group) for t in into]
        reqs = dist.batch_isend_irecv(ops)

        def wait():
            for r in reqs:
                r.wait()
            return into[0], into[1], (into[2].bool() if key_mask is not None else None)

        return wait

    return rotate


def local_transport(blocks: list[tuple], rank: int):
    """The rotation rank ``rank`` of a ``len(blocks)``-rank ring sees, from
    every block held in one process: at hop ``i`` it holds block ``rank - i``."""
    p = len(blocks)
    hop = [0]

    def rotate(k, v, key_mask):
        hop[0] += 1
        nxt = blocks[(rank - hop[0]) % p]
        return lambda: nxt

    return rotate


def seq_blocks(t, p: int, dim: int) -> list[torch.Tensor]:
    """``t`` cut into ``p`` equal blocks along ``dim`` (views)."""
    if t.shape[dim] % p:
        raise ValueError(f"sequence of {t.shape[dim]} frames does not divide over {p} context-parallel ranks")
    return list(torch.chunk(t, p, dim))


def ring_attention(q, k, v, key_mask, cp: Axis):
    """Ring attention with the JAX signature: ``(b, h, n, d)`` q/k/v and the
    ``(b, n)`` key mask (or None) as every rank of ``cp`` holds them; this
    rank computes its block of queries around the ring and the blocks are
    gathered back to ``(b, h, n, d)`` on every rank (what ``shard_map`` under
    an ambient mesh gives the DiT). ``n`` must divide over the ring."""
    p, r = cp.size, cp.index
    qb, kb, vb = (seq_blocks(t, p, 2)[r] for t in (q, k, v))
    mb = seq_blocks(key_mask, p, 1)[r] if key_mask is not None else None
    o = ring_body(qb, kb, vb, mb, p, ring_transport(cp))
    return cp.all_gather(o, 2)
