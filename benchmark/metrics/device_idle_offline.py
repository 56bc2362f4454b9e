"""The device's idle share of the traced part of a offline cell, in %."""

from benchmark.metrics._idle import idle_percent


def read(ctx):
    return idle_percent(ctx)
