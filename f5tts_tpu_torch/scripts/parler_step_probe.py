"""Parler decode-step layout probe (counterpart of ``scripts/parler_step_probe.py``).

Minimal decode-step programs at indic-parler-tts's decoder geometry (24
layers, hidden 1024, ffn 4096, 16 heads, bf16; batch 16, a 494-position
cache, 64 encoder states), each advancing ``--steps`` positions from one
hidden state, timed two ways: the eager loop (host clock, ended in a host
sync, median of ``--iters`` after a warm run) and the same loop captured
once in a CUDA graph and replayed (CUDA events, median of ``--iters``
replays). The graph is PyTorch's form of the JAX script's one jitted scan;
the positions are fixed, so each is baked into the graph. Variants:

- ``stacked``: one ``(L, b, h, total, d)`` cache for K and one for V,
  weights and caches indexed per layer at run time, each position written
  with ``index_copy_`` (the JAX script's shipping pattern);
- ``unrolled``: per-layer caches and per-layer weight views;
- ``fusedqkv``: ``unrolled`` with one ``(hidden, 3 hidden)`` q|k|v product
  a layer (the JAX variant also folds the cross-attention query into it,
  taken from the first norm's output, which changes the result; the port
  fuses q|k|v as its decode step does, ``fuse_decode_qkv``);
- ``shortcache``: ``unrolled`` with a 256-position cache (cache-byte
  sensitivity: the attention reads the whole cache every step);
- ``noattn``: ``unrolled`` without the self-attention (weights and FF only);
- ``kernelattn``: ``fusedqkv`` with self- and cross-attention through
  ``ops/kernels/decode_attention.py:decode_attention`` (the JAX script's
  ``pallasattn``), on the port's one cache layout ``(b, h, total, d)``,
  untransposed and unpadded.

The bound per step is the JAX script's: the weights (no embeddings) and the
whole cache read once, at the card's 3.35 TB/s (``utils/timing.py``).
``StepProbe`` holds the weights and builds each variant; ``run`` times them.

    python -m f5tts_tpu_torch.scripts.parler_step_probe                   # one CUDA card
    python -m f5tts_tpu_torch.scripts.parler_step_probe --device cpu --batch 2 --layers 2 --hidden 128 \\
        --ffn 256 --heads 4 --total 40 --enc-len 8 --steps 4 --iters 1
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from f5tts_tpu_torch.ops.kernels.decode_attention import decode_attention
from f5tts_tpu_torch.utils.device import resolve_device
from f5tts_tpu_torch.utils.timing import PEAK_BYTES, card_line, graph_seconds, median_seconds

VARIANTS = ("stacked", "unrolled", "fusedqkv", "shortcache", "noattn", "kernelattn")
SHORT_TOTAL = 256
MASKED = -1e9


class StepProbe:
    """The probe's weights (``np.random.default_rng(0)``, the JAX script's
    order and shapes, ``0.02``-scaled normals), the cross-attention K/V and
    the first hidden state; ``variant(name)`` allocates that variant's caches
    and returns a function that runs the positions and returns the last
    hidden state ``(b, 1, hidden)``."""

    def __init__(self, batch: int = 16, layers: int = 24, hidden: int = 1024, ffn: int = 4096, heads: int = 16,
                 total: int = 494, enc_len: int = 64, steps: int = 64, dtype=torch.bfloat16, device="cuda"):
        self.b, self.L, self.H, self.F, self.NH = batch, layers, hidden, ffn, heads
        self.D = hidden // heads
        self.total, self.enc_len, self.steps = total, enc_len, steps
        self.dtype, self.device = dtype, torch.device(device)
        rng = np.random.default_rng(0)

        def w(*shape):
            return torch.as_tensor(rng.standard_normal(shape) * 0.02).to(device=self.device, dtype=dtype)

        L, H = layers, hidden
        p = {name: w(L, H, H) for name in ("wq", "wk", "wv", "wo", "cq", "co")}
        p["f1"], p["f2"] = w(L, H, ffn), w(L, ffn, H)
        for name in ("ln1", "ln2", "ln3"):
            p[name] = torch.ones((L, H), dtype=dtype, device=self.device)
        self.params = p
        self.ca_k = w(L, batch, heads, enc_len, self.D)
        self.ca_v = w(L, batch, heads, enc_len, self.D)
        self.x0 = w(batch, 1, H)
        self.per_layer = [{k: v[l] for k, v in p.items()} for l in range(L)]
        self.ca_bias = torch.zeros((batch, enc_len), dtype=torch.float32, device=self.device)
        self.caches: dict[str, object] = {}
        self.hidden: dict[str, torch.Tensor] = {}  # variant -> its eager run's last hidden state (fp32, host)

    # -- pieces ---------------------------------------------------------------

    def w_bytes(self) -> int:
        """Bytes of the weights a step streams (bf16; no embeddings, the
        cross-attention K/V excluded), the JAX script's count."""
        return 2 * self.L * (4 * self.H * self.H + 2 * self.H * self.H + 2 * self.H * self.F)

    def cache_bytes(self, name: str) -> int:
        """Bytes of the whole K and V cache, read once a step (none for ``noattn``)."""
        if name == "noattn":
            return 0
        tot = SHORT_TOTAL if name == "shortcache" else self.total
        return 2 * self.L * 2 * self.b * self.NH * tot * self.D

    def biases(self, tot: int) -> torch.Tensor:
        """``(steps, b, tot)`` fp32: position ``j``'s causal bias (0 up to ``j``)."""
        pos = torch.arange(tot, device=self.device)
        allowed = pos[None, :] <= torch.arange(self.steps, device=self.device)[:, None]
        return torch.where(allowed, 0.0, MASKED).to(torch.float32)[:, None, :].expand(-1, self.b, -1).contiguous()

    def ln(self, x, g):
        return F.layer_norm(x.float(), (self.H,), g.float(), None, 1e-5).to(x.dtype)

    def heads(self, t):
        """``(b, 1, hidden)`` -> ``(b, heads, 1, d)``: one position, so a view."""
        return t.view(self.b, self.NH, 1, self.D)

    def attend(self, q, kc, vc, bias):
        """Softmax attention of the pre-scaled ``(b, h, 1, d)`` query over a
        ``(b, h, n, d)`` cache with an additive ``(b, n)`` fp32 bias: fp32
        scores and softmax, weights in the cache dtype."""
        s = (q @ kc.transpose(-1, -2)).float() + bias[:, None, None, :]
        return (torch.softmax(s, -1).to(vc.dtype) @ vc).view(self.b, 1, self.H)

    def ff(self, h, f1, f2):
        return F.gelu(h @ f1) @ f2  # exact (erf) GELU

    # -- variants -------------------------------------------------------------

    def variant(self, name: str):
        if name not in VARIANTS:
            raise ValueError(f"unknown variant {name!r}; have {VARIANTS}")
        self.caches.clear()
        if name == "stacked":
            return self._stacked()
        return self._unrolled(fused=name in ("fusedqkv", "kernelattn"),
                              tot=SHORT_TOTAL if name == "shortcache" else self.total,
                              attn=name != "noattn", kernel=name == "kernelattn")

    def _stacked(self):
        b, NH, D, L = self.b, self.NH, self.D, self.L
        p, scale = self.params, self.D**-0.5
        ck = torch.zeros((L, b, NH, self.total, D), dtype=self.dtype, device=self.device)
        cv = torch.zeros_like(ck)
        self.caches["stacked"] = (ck, cv)
        biases = self.biases(self.total)
        pos = [torch.tensor([j], device=self.device) for j in range(self.steps)]

        def run():
            h = self.x0
            for j in range(self.steps):
                for l in range(L):
                    xn = self.ln(h, p["ln1"][l])
                    q = self.heads(xn @ p["wq"][l]) * scale
                    ck[l].index_copy_(2, pos[j], self.heads(xn @ p["wk"][l]))
                    cv[l].index_copy_(2, pos[j], self.heads(xn @ p["wv"][l]))
                    h = h + self.attend(q, ck[l], cv[l], biases[j]) @ p["wo"][l]
                    xn = self.ln(h, p["ln2"][l])
                    qc = self.heads(xn @ p["cq"][l]) * scale
                    h = h + self.attend(qc, self.ca_k[l], self.ca_v[l], self.ca_bias) @ p["co"][l]
                    h = h + self.ff(self.ln(h, p["ln3"][l]), p["f1"][l], p["f2"][l])
            return h

        return run

    def _unrolled(self, fused: bool, tot: int, attn: bool, kernel: bool):
        b, NH, D, H = self.b, self.NH, self.D, self.H
        scale = D**-0.5
        store = torch.zeros((self.L, 2, b, NH, tot, D), dtype=self.dtype, device=self.device)
        caches = [(store[l, 0], store[l, 1]) for l in range(self.L)]
        self.caches["unrolled"] = caches
        biases = self.biases(tot)
        attend = self.attend_kernel if kernel else self.attend
        wqkv = [torch.cat([pl["wq"], pl["wk"], pl["wv"]], dim=-1) for pl in self.per_layer] if fused else None

        def run():
            h = self.x0
            for j in range(self.steps):
                for l, pl in enumerate(self.per_layer):
                    ck, cv = caches[l]
                    xn = self.ln(h, pl["ln1"])
                    if fused:
                        qkv = xn @ wqkv[l]
                        q, kn, vn = qkv[..., :H], qkv[..., H:2 * H], qkv[..., 2 * H:]
                    else:
                        q, kn, vn = xn @ pl["wq"], xn @ pl["wk"], xn @ pl["wv"]
                    ck[:, :, j] = kn.view(b, NH, D)
                    cv[:, :, j] = vn.view(b, NH, D)
                    if attn:
                        h = h + attend(self.heads(q) * scale, ck, cv, biases[j]) @ pl["wo"]
                    xn = self.ln(h, pl["ln2"])
                    qc = self.heads(xn @ pl["cq"]) * scale
                    h = h + attend(qc, self.ca_k[l], self.ca_v[l], self.ca_bias) @ pl["co"]
                    h = h + self.ff(self.ln(h, pl["ln3"]), pl["f1"], pl["f2"])
            return h

        return run

    def attend_kernel(self, q, kc, vc, bias):
        """The decode-attention kernel's wrapper (its plain version on the CPU)."""
        return decode_attention(q.contiguous(), kc, vc, bias).view(self.b, 1, self.H)


def run(probe: StepProbe, variants=VARIANTS, iters: int = 3, graph: bool = True, log=print) -> dict:
    """Every variant's eager and (on the card) graph time per step, its bound,
    the decode-attention kernel's launches in one eager run and how far the
    graph's last hidden state is from the eager run's (``probe.hidden`` keeps
    the eager ones)."""
    dev = probe.device
    card = card_line(dev)
    w_bytes = probe.w_bytes()
    rows = []
    for name in variants:
        fn = probe.variant(name)
        before = decode_attention.launches
        # the warm run, whose kernel launches are counted (a graph's Python counters fire once, at capture)
        probe.hidden[name] = fn().float().cpu()
        launches = decode_attention.launches - before
        med, _ = median_seconds(fn, dev, iters, warmup=0)
        step_us = med / probe.steps * 1e6
        bound_us = (w_bytes + probe.cache_bytes(name)) / PEAK_BYTES * 1e6
        row = {"variant": name, "step_us": step_us, "bound_us": bound_us, "bw_eff": bound_us / step_us,
               "decode_attention_launches": launches}
        if graph and dev.type == "cuda":
            g_med, (g, out) = graph_seconds(fn, replays=iters)
            row["graph_step_us"] = g_med / probe.steps * 1e6
            row["graph_bw_eff"] = bound_us / row["graph_step_us"]
            row["graph_vs_eager_max_abs"] = float((out.float().cpu() - probe.hidden[name]).abs().max())
            del g, out
        rows.append(row)
        log(json.dumps({**{k: (round(v, 3) if isinstance(v, float) else v) for k, v in row.items()}, "card": card}))
        del fn
        probe.caches.clear()
    return {"w_bytes_per_step": w_bytes, "card": card, "rows": rows}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("f5tts_tpu_torch.scripts.parler_step_probe")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--layers", type=int, default=24)
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--ffn", type=int, default=4096)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--total", type=int, default=494)
    p.add_argument("--enc-len", type=int, default=64)
    p.add_argument("--steps", type=int, default=64, help="decode positions per timed program")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--out", default=None, help="JSON result file (default: stdout only)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    probe = StepProbe(args.batch, args.layers, args.hidden, args.ffn, args.heads, args.total, args.enc_len,
                      args.steps, device=dev)
    results = {"args": vars(args), **run(probe, args.variants.split(","), args.iters)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
