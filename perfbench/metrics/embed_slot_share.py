"""Useful embeds over embeds run, in %: the faces in the results of the
window's batches over the slots the embed stage ran in the window (the
program's ``embed_stats["slots"]``: a speculated launch's rung, every slot
of a whole launch, a redo's rung). None where the program keeps no such
counter."""


def read(run):
    slots = run.get("embed_stats", {}).get("slots")
    if not slots:
        return None
    return 100.0 * sum(faces for _, _, faces in run["batches"]) / slots
