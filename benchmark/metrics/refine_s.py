"""Seconds per refinement: the whole window over the refinements finished
in it (host clock)."""


def read(run):
    return run.window_s / len(run.outputs) if run.outputs else None
