"""Host ms a request spends in ``prepare_request`` and ``finalize_request``
(the harness's own spans around the two calls), over the window's requests."""


def read(ctx):
    spans = ctx.counters.get("spans", {})
    n = len(spans.get("prepare_request", []))
    if not n:
        return None
    return 1e3 * (sum(spans["prepare_request"]) + sum(spans.get("finalize_request", []))) / n
