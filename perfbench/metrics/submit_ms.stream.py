"""The main thread's ``submit_encoded`` a batch, from the harness's
``submit`` spans over the window, in ms: what the engine's launches cost
the thread that sets the pace."""

from perfbench.metrics._spans import per_call_ms


def read(run):
    lo, hi = run["window"]
    return per_call_ms(run["spans"].items, "submit", lo, hi)
