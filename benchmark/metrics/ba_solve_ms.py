"""Milliseconds per solve: the whole window over the solves finished in it
(host clock)."""


def read(run):
    return 1e3 * run.window_s / len(run.outputs) if run.outputs else None
