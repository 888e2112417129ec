"""Faces a wall-clock second of the traced run's window: the faces in the
results of every batch fetched in it over its length on the host's clock.
The rate at which the host paces the stream, where the card idles between
batches; ``faces_per_busy_s`` is the card's side of it."""


def read(run):
    if not run["batches"]:
        return None
    return run["faces_per_s"]
