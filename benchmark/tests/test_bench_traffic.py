"""The traffic repeats from its seed, and every seed offers the same work."""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import core  # noqa: E402
from benchmark.traffic import offline_rows  # noqa: E402

OFFLINE = core.load_cell("f5tts-base.offline-longform")


def test_offline_requests_repeat_and_share_one_pool():
    n = OFFLINE.traffic["paragraphs"]
    take = lambda seed: [next(g) for g in [offline_rows.requests(OFFLINE, seed)] for _ in range(n + 3)]  # noqa: E731
    a, b, c = take(9), take(9), take(10)
    assert a == b
    assert [(r["text"], r["voice"]) for r in a] == [(r["text"], r["voice"]) for r in c]
    assert [r["seed"] for r in a] != [r["seed"] for r in c]
    assert [r["text"] for r in a[n:]] == [r["text"] for r in a[:3]]


def test_voices_keep_lengths_and_transcripts_across_seeds():
    from benchmark import serving

    a, b = serving.voices(OFFLINE, 1), serving.voices(OFFLINE, 2)
    assert [len(v["audio"]) for v in a] == [int(s * 24000) for s in OFFLINE.traffic["voice_seconds"]]
    assert [v["text"] for v in a] == [v["text"] for v in b]
    assert not np.array_equal(a[0]["audio"], b[0]["audio"])
