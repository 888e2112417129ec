"""Share of the traced slice's wall time in which no kernel, memcpy or
memset ran on the card, in %."""

from perfbench import trace


def read(run):
    dt = run["trace"]
    if dt is None or not dt.events:
        return None
    return 100.0 * trace.idle_share([e[1:] for e in dt.events], dt.lo, dt.hi)
