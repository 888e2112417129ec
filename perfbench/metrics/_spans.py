"""Shared arithmetic of the span readers (not a metric: its name starts
with an underscore)."""


def per_call_ms(spans, name: str, lo: float, hi: float, per: int | None = None):
    """Milliseconds of the spans ``name`` that start in [lo, hi], over their
    count (or over ``per``, where the work is counted a batch); None where
    there is none."""
    picked = [(s, e) for n, s, e in spans if n == name and lo <= s < hi]
    count = len(picked) if per is None else per
    if not picked or not count:
        return None
    return 1e3 * sum(e - s for s, e in picked) / count
