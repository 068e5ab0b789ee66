"""LM tries per solve (``BAResult.tries``), the window's mean."""


def read(run):
    if not run.outputs:
        return None
    return sum(o["tries"] for o in run.outputs) / len(run.outputs)
