"""Host syncs a batch in the traced slice: the CUDA runtime's blocking
calls (``cudaStreamSynchronize``, ``cudaEventSynchronize``,
``cudaDeviceSynchronize``, a non-async ``cudaMemcpy``) made inside the
engine's ``frp.submit_encoded`` and ``frp.fetch_many`` spans, on their
thread, over the slice's batches."""

from perfbench.metrics._program import SYNC_CALLS, batches, host_events, made_in

CALLS = ("frp.submit_encoded", "frp.fetch_many")


def read(run):
    events = host_events(run)
    if not events:
        return None
    n = batches(events)
    if not n:
        return None
    return sum(1 for e in events if e.name in SYNC_CALLS and made_in(e, CALLS)) / n
