"""The launch plans of two CUDA kernels, checked on the CPU (no card needed):
the decode-attention kernel's split of the cache positions over a
thread-block cluster, and the attention-layout ablation kernel's count of its
``wgmma`` products in m16n8k16 equivalents against ``mma_per_call``."""

import pytest
import torch

from f5tts_tpu_torch.ops.kernels import ablate_attention as ta
from f5tts_tpu_torch.ops.kernels import decode_attention as td
from f5tts_tpu_torch.scripts import decode_splits

# (b, n_kv, group, total): Parler's self- and cross-attention at b 1 / 16 / 32, GQA groups, short and long caches
SHAPES = [(16, 16, 1, 503), (16, 16, 1, 64), (1, 16, 1, 503), (32, 16, 1, 503), (4, 2, 8, 200), (3, 2, 3, 77),
          (2, 4, 1, 1), (1, 2, 2, 70000), (1, 16, 16, 503), (2, 2, 8, 4099), (64, 16, 1, 1000), (1, 1, 1, 31)]


@pytest.mark.parametrize("b,n_kv,group,total", SHAPES)
def test_decode_split_puts_every_position_in_exactly_one_span(b, n_kv, group, total):
    split, span = td.decode_split(b, n_kv, group, total)
    assert 1 <= split <= td.MAX_CLUSTER
    spans = [range(r * span, min(total, (r + 1) * span)) for r in range(split)]
    assert all(len(s) > 0 for s in spans)  # no block without a position
    assert [p for s in spans for p in s] == list(range(total))
    assert split == 1 or span >= td.MIN_SPAN  # a split leaves every block its least span


@pytest.mark.parametrize("b", [1, 16, 32])
@pytest.mark.parametrize("total", [64, 503])
def test_decode_split_reaches_two_blocks_per_sm_or_its_limits(b, total):
    """Parler's shapes (16 heads): the grid has at least ~2 blocks per SM of an
    H100 unless the cluster size (8) or the least span stops the split; at b 1
    the cluster is as large as the least span allows."""
    split, span = td.decode_split(b, 16, 1, total)
    grid = b * 16 * split
    stopped = split == td.MAX_CLUSTER or -(-total // (2 * split)) < td.MIN_SPAN
    assert grid >= td.BLOCKS_PER_SM * td.H100_SMS or stopped
    if b == 1:
        largest = max(s for s in (1, 2, 4, 8) if s == 1 or -(-total // s) >= td.MIN_SPAN)
        assert split == largest


def test_decode_split_at_parlers_shapes():
    """The splits the card sweeps chose (PERF.md): self-attention 2 at b 16, 1
    at b 32, 8 at b 1; the 64-position cross-attention unsplit."""
    assert [td.decode_split(b, 16, 1, 503)[0] for b in (16, 32, 1)] == [2, 1, 8]
    assert td.decode_split(16, 16, 1, 64) == (1, 64)


def test_decode_split_follows_the_card_and_the_group_tile():
    assert [td.group_tile(g) for g in (1, 2, 3, 4, 8)] == [1, 2, 4, 4, 4]
    # a card with fewer SMs needs fewer blocks; the group tile counts into the grid
    assert td.decode_split(16, 16, 1, 503, sms=16)[0] < td.decode_split(16, 16, 1, 503)[0]
    assert td.decode_split(4, 2, 8, 503)[0] <= td.decode_split(4, 2, 4, 503)[0] * 2


# The ablation kernel's issue schedule (csrc/ablate_attention.cu): keys per tile, and the wgmma m64nNk16 a
# consumer warpgroup (64 query rows) issues per tile as (N, how many), S first, then P V.
WGMMA_KEY_TILE = {"unpacked": 128, **{layout: 64 for layout in ta.PAIR_LAYOUTS}}
WGMMA_PER_TILE = {
    "unpacked": ((128, 4), (64, 8)),              # s = q.k^T over 128 keys in 4 k-steps; o += p.v, 8 k-steps
    "packed_blockdiag": ((128, 8), (128, 8)),     # [qa|qb].blockdiag(ka,kb)^T; [pa|pb].blockdiag(va,vb)
    "packed_sep_o": ((128, 8), (64, 8)),          # the same s; pa.va and pb.vb, 4 k-steps each
    "sumdiff_blockdiag": ((64, 16), (128, 8)),    # ssum and sdif, 8 k-steps each; o as packed_blockdiag
    "sumdiff_dense_cross": ((64, 16), (128, 8)),  # the same s; pa.[va|vb] and pb.[va|vb], 4 k-steps each
}


def _counted_per_call(layout, bh, n):
    """What the kernel's warpgroups count for one call: every wgmma of the
    schedule in m16n8k16 equivalents, over every tile of every 64-row warpgroup."""
    warpgroups = bh // (1 if layout == "unpacked" else 2) * (n // 64)
    per_tile = sum(ta.m16n8k16_equivalents(cols) * count for cols, count in WGMMA_PER_TILE[layout])
    return warpgroups * (n // WGMMA_KEY_TILE[layout]) * per_tile


def test_decode_split_sweep_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        decode_splits.main()


@pytest.mark.parametrize("n_cols,equivalents", [(64, 32), (128, 64), (256, 128)])
def test_a_wgmma_counts_four_warps_of_m16n8k16(n_cols, equivalents):
    assert ta.m16n8k16_equivalents(n_cols) == equivalents == 4 * n_cols // 8


@pytest.mark.parametrize("bq", ta.BLOCK_QS)
@pytest.mark.parametrize("layout", ta.LAYOUTS)
@pytest.mark.parametrize("bh,n", [(2, 128), (8, 256), (8, 1024), (256, 1024)])
def test_wgmma_products_equal_mma_per_call(layout, bq, bh, n):
    """What the kernel's warpgroups count (each wgmma m64nNk16 of the layout's
    schedule as 4 N / 8 m16n8k16) equals ``mma_per_call``, at either block size."""
    assert n % bq == 0 and n % ta.N_MULTIPLE == 0
    assert _counted_per_call(layout, bh, n) == ta.mma_per_call(layout, bh, n)


def test_wgmma_schedule_issues_the_layouts_extra_products():
    per_tile = {layout: sum(ta.m16n8k16_equivalents(c) * k for c, k in WGMMA_PER_TILE[layout])
                * 64 // WGMMA_KEY_TILE[layout] for layout in ta.LAYOUTS}  # per 64 keys of a head (or pair)
    unpacked = per_tile["unpacked"]
    assert per_tile == {"unpacked": unpacked, "packed_blockdiag": 4 * unpacked, "packed_sep_o": 3 * unpacked,
                        "sumdiff_blockdiag": 4 * unpacked, "sumdiff_dense_cross": 4 * unpacked}
