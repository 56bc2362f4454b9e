"""One module per model family: the weight layout the benchmark draws, the
program's constructors for it, and the FLOP arithmetic of its forward.
A configuration file names its family (``"family"``) and its vocoder's."""

import importlib


def family(name: str):
    return importlib.import_module(f"benchmark.backbones.{name}")
