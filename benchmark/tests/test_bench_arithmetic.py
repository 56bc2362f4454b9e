"""The yardstick's FLOP and byte counts against hand-worked values at small
shapes (each product counted as 2 FLOPs per multiply-add)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.backbones import dit, unett, vocos  # noqa: E402
from benchmark.metrics import _work  # noqa: E402

M = {"dim": 64, "depth": 2, "heads": 2, "dim_head": 32, "ff_mult": 2, "mel_dim": 100, "text_num_embeds": 10,
     "text_dim": 32, "conv_layers": 1}
V = {"input_channels": 100, "dim": 48, "intermediate_dim": 96, "num_layers": 2, "n_fft": 1024, "hop_length": 256}


def test_dit_row_forward_flops():
    n = 10
    per_frame = (2 * 232 * 64  # input projection of [x, cond, text] (100 + 100 + 32)
                 + 2 * (2 * 31 * 4 * 64)  # two grouped k-31 convs, 4 inputs per output channel
                 + 2 * (4 * 2 * 64 * 64  # q, k, v, out
                        + 2 * 64 * 128 + 2 * 128 * 64  # feed-forward in, out
                        + 2 * 2 * n * 64)  # q k^T and p v over n keys, 2 heads x 32
                 + 2 * 64 * 100)  # projection to mel
    per_row = (2 * 256 * 64 + 2 * 64 * 64  # time MLP
               + 2 * (2 * 64 * 384)  # AdaLN modulations (6 x 64) of 2 blocks
               + 2 * 64 * 128)  # final AdaLN (2 x 64)
    assert dit.row_forward_flops(M, n) == per_frame * n + per_row == 2_259_968


def test_unett_row_forward_flops():
    m = {**M, "ff_mult": 4}
    n = 10
    embed = 2 * 232 * 64 + 2 * (2 * 31 * 4 * 64) + 2 * 64 * 100
    per_pos = 2 * (4 * 2 * 64 * 64 + 2 * 64 * 256 + 2 * 256 * 64 + 2 * 2 * (n + 1) * 64) + 1 * 2 * 128 * 64
    assert unett.row_forward_flops(m, n) == embed * n + per_pos * (n + 1) + 2 * 256 * 64 + 2 * 64 * 64


def test_vocos_frame_flops():
    assert vocos.frame_flops(V) == (2 * 7 * 100 * 48 + 2 * (2 * 7 * 48 + 2 * 48 * 96 + 2 * 96 * 48)
                                    + 2 * 48 * 1026 + 2 * 2 * 513 * 1024) == 2_305_152


class _Ctx:
    def __init__(self, family):
        self.cell = type("C", (), {"config": {"family": family, "model": M, "vocoder": {**V, "family": "vocos"},
                                              "serving": {"sampler": {"method": "ralston"}}}})()

    def family(self):
        return {"dit": dit, "unett": unett}[self.cell.config["family"]]

    def vocoder(self):
        return vocos


def test_attention_least_time_is_the_byte_bound_at_a_small_shape():
    # 1 solve of 1 row (2 with CFG), 10 frames, 1 step of 2 evals, 2 layers of 2 heads x 32
    flops = 4 * 2 * 2 * 10 * 10 * 32
    nbytes = 4 * 2 * 2 * 10 * 32 * 2
    assert nbytes / 3.35e12 > flops / 989e12
    want = 2 * 1 * 2 * nbytes / 3.35e12
    assert _work.attention_least_s(_Ctx("dit"), [(1, 10, 1)]) == pytest.approx(want, rel=1e-12)


def test_attention_least_time_is_the_flop_bound_at_the_serving_shape():
    m = {**M, "heads": 16, "dim_head": 64, "depth": 22}
    ctx = _Ctx("dit")
    ctx.cell.config["model"] = m
    flops = 4 * 16 * 16 * 1024 * 1024 * 64  # 8 rows with CFG
    assert _work.attention_least_s(ctx, [(8, 1024, 10)]) == pytest.approx(20 * 22 * flops / 989e12, rel=1e-12)


def test_solve_flops_counts_both_guidance_branches_and_vocos():
    got = _work.solve_flops(_Ctx("dit"), [(2, 10, 3)])
    assert got == 2 * 2 * 2 * 3 * dit.row_forward_flops(M, 10) + 2 * 10 * vocos.frame_flops(V)
