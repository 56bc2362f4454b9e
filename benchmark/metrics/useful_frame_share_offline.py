"""Frames the window's rows need (each row's duration within its bucket) over
frames solved (batch bucket x duration bucket per solve, from the harness's
wrapper on ``bucket_program``), in %: the waste of the buckets and caps."""


def read(ctx):
    solved = sum(bb * nb for bb, nb, _ in ctx.counters.get("solves", []))
    if not solved:
        return None
    return 100.0 * ctx.counters["rows_needed"] / solved
