"""The launch plans of three CUDA kernels, checked on the CPU (no card
needed): the decode-attention kernel's split of the cache positions over a
thread-block cluster, the attention-layout ablation kernel's count of its
``wgmma`` products in m16n8k16 equivalents against ``mma_per_call``, and the
int8 matmul's tiles, N split and path."""

import pytest
import torch

from f5tts_tpu_torch.ops.kernels import ablate_attention as ta
from f5tts_tpu_torch.ops.kernels import decode_attention as td
from f5tts_tpu_torch.ops.kernels import quant_matmul as tqm
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


# the rows quant_matmul gets from the int8 engine: 2 (CFG) x batch bucket x duration bucket
ENGINE_M = sorted({2 * b * n for n in (256, 512, 768, 1024, 1536, 2048, 3072, 4096) for b in (1, 2, 4, 8, 16, 32)})
BASE_KN = [(1024, 1024), (1024, 2048), (2048, 1024)]  # F5-TTS Base: q/k/v/out, ff in, ff out


@pytest.mark.parametrize("k,n", BASE_KN + [(4096, 1024), (5504, 64), (80, 48), (16, 16), (1152, 1040)])
@pytest.mark.parametrize("m", [1, 77, 300, 512, 1000, 2048, 6144, 16384, 16385])
def test_quant_plan_covers_every_row_and_column_exactly_once(m, k, n):
    p = tqm.plan(m, k, n)
    rows = [r for x in range(p.row_blocks) for r in p.row_range(x, m)]
    assert rows == list(range(m))
    assert all(len(p.n_range(y)) >= 1 for y in range(p.split))  # no block without a tile
    cols = [c for y in range(p.split) for t in p.n_range(y) for c in range(t * p.bn, min(n, (t + 1) * p.bn))]
    assert cols == list(range(n))
    assert p.smem == tqm.smem_bytes(p.streamed, k) <= tqm.MAX_SMEM
    assert tqm.fits(p.streamed, k) and tqm.ring_stages(p.streamed, k) >= tqm.MIN_STAGES
    assert p.split <= 65535 and (p.bm, p.bn) == (tqm.BM, tqm.BN)


@pytest.mark.parametrize("k,n", BASE_KN)
def test_quant_plan_fills_the_card_at_every_engine_bucket(k, n):
    """Every M the engine produces gets at least ~0.7 x 132 blocks, or as
    many as its tiles allow (every N tile its own block); the fused path only
    where its 128-row blocks alone occupy half the card, so it never splits N
    (which would quantize a row in every block that shares it)."""
    for m in ENGINE_M:
        p = tqm.plan(m, k, n)
        assert p.blocks >= 0.7 * tqm.H100_SMS or p.split == p.n_tiles, (m, p)
        assert p.streamed == (k > 1152 or 2 * -(-m // 128) < tqm.H100_SMS), (m, p)
        assert p.streamed or p.split == 1


def test_quant_plan_has_a_path_for_every_shape_the_first_kernel_took():
    """The kernel's first design took K up to 5504 (multiples of 16) at any M and N: the
    fused path while the 128 rows' int8 copy fits the block's shared memory
    beside a ring of 3 stages (K up to 1152) and the rows fill half the card,
    the streamed path elsewhere, up to ``MAX_K``."""
    for k in range(16, 5504 + 1, 16):
        for m, n in ((1, 16), (300, 48), (16384, 1024)):
            p = tqm.plan(m, k, n)
            assert p.smem <= tqm.MAX_SMEM and p.blocks >= 1
            assert p.streamed == (k > 1152 or m < 16384), k
    assert tqm.plan(8, tqm.MAX_K, 16).streamed


def test_quant_plan_at_the_serving_shapes():
    """The bench geometry (16 x 1024 rows): one block per 128 rows on the
    fused path, no N split (each row quantized once), at q/k/v/out and ff in;
    ff out (K 2048) and a lone 1024-bucket request (M 2048) take the streamed
    path, the latter split so that 128 blocks run."""
    p = tqm.plan(16384, 1024, 1024)
    assert (p.streamed, p.split, p.blocks) == (False, 1, 128)
    assert (tqm.plan(16384, 1024, 2048).streamed, tqm.plan(16384, 1024, 2048).blocks) == (False, 128)
    assert tqm.plan(16384, 2048, 1024).streamed
    small = tqm.plan(2048, 1024, 1024)
    assert small.streamed and small.blocks == 128 and small.split == 8
