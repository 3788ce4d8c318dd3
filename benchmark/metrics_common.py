"""Arithmetic that several per-layer readers share."""
from benchmark.counts.peaks import OPS_PER_S


def mfu(view, ops):
    """100 x (sum over precisions of `ops`, the stretch's operations, over
    that precision's peak) / the stretch's length; None without a length."""
    w = view.trace_window_s()
    if not w:
        return None
    return 100.0 * sum(n / OPS_PER_S[p] for p, n in ops.items() if n) / w
