"""Device kernels a batch: the kernels in the traced slice over the batches
submitted in it (``torch.profiler``; memcpy and memset left out)."""


def read(run):
    dt = run["trace"]
    if dt is None:
        return None
    n = sum(1 for name, s, _ in run["spans"].items if name == "submit" and dt.lo <= s < dt.hi)
    kernels = [e for e in dt.kernels() if dt.lo <= e[1] < dt.hi]
    if not n or not kernels:
        return None
    return len(kernels) / n
