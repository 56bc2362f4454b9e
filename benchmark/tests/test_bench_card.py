"""The control of each cell's comparison, run on the card at the cell's own
size: on three seeds the program is correct and each of the cell's controls
is not (F5: the program's own W8A8 int8 path, and the reference held in fp8
in the program's place; E2, which has no int8 path: the reference in fp8). Marked ``cuda``: skips without a card.

    python -m pytest --noconftest -o addopts="" -m cuda benchmark/tests/test_bench_card.py
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

CELLS = ["f5tts-base.offline-longform", "e2tts-base.offline-longform"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their published widths")
    from benchmark import run

    run.setup_env()
    return run


def card_controls(cell):
    from benchmark import core

    return core.load_cell(cell).workload["controls"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(card, cell):
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        sound = card.run_cell(cell, seed, 15.0, False)
        assert sound["correct"], sound["checks"]
        for which in card_controls(cell):
            control = card.run_cell(cell, seed, 15.0, False, control=which)
            assert not control["correct"], (which, control["checks"])
