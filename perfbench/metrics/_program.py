"""The program's own spans in the traced slice (not a metric: its name
starts with an underscore): the ``frp.*`` host events of the harness's
profile (``run["trace"].prof``, started on the main thread, where
``submit_encoded``, the stages and ``fetch_many`` run), the device time of
the kernels and copies launched inside each, and the synchronizing CUDA
calls made inside them. Every reader returns None where the slice holds no
``frp.submit_encoded`` span, as a program without spans gives.

Two things of ``torch.profiler``'s host tree are read around. The CUDA
runtime's calls of threads the profile does not record (the harness's
transfer thread) land in the main thread's tree by time, so a call counts
only where its system thread (``device_resource_id``) is the span's. And
another host event may carry the id of the op that launched a kernel,
and with it a second copy of that op's kernels, so a subtree counts each
id's kernels once."""

BATCH = "frp.submit_encoded"
# the CUDA runtime's calls that block the host until the card has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy")


def host_events(run) -> list | None:
    """The profile's host events, or None without a traced slice."""
    dt = run.get("trace")
    if dt is None or getattr(dt, "prof", None) is None:
        return None
    return [e for e in dt.prof.events() if e.device_type.name == "CPU"]


def batches(events) -> int:
    """The slice's batches: its ``frp.submit_encoded`` spans."""
    return sum(1 for e in events if e.name == BATCH)


def device_us(ev) -> float:
    """The device us of the kernels and copies launched inside a host event
    and its children, each id's once."""
    by_id: dict = {}
    todo = [ev]
    while todo:
        e = todo.pop()
        if e.kernels and e.id not in by_id:
            by_id[e.id] = sum(k.duration for k in e.kernels)
        todo.extend(e.cpu_children)
    return sum(by_id.values())


def stage_ms(run, name: str):
    """Device ms a batch of the spans ``name`` in the slice."""
    events = host_events(run)
    if not events:
        return None
    n = batches(events)
    if not n:
        return None
    return sum(device_us(e) for e in events if e.name == name) / 1e3 / n


def made_in(ev, names) -> bool:
    """Whether a host event is nested in a span named one of ``names`` and
    was made on that span's thread."""
    p = ev.cpu_parent
    while p is not None:
        if p.name in names:
            return getattr(ev, "device_resource_id", None) == getattr(p, "device_resource_id", None)
        p = p.cpu_parent
    return False
