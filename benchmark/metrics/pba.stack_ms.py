"""Host milliseconds a traced refinement spends casting its levels' image
stacks to bf16: the levels' ``stack_s`` (the program's ``pba.level.stack``
spans, each between two device syncs), summed over the pyramid and
averaged over the traced requests.  None where the levels carry no
``stack_s`` (a program without the span)."""


def read(run):
    traced = run.outputs[:run.traced]
    if run.trace is None or not traced:
        return None
    levels = [lv for o in traced for lv in o["levels"]]
    if not all("stack_s" in lv for lv in levels):
        return None
    return 1e3 * sum(lv["stack_s"] for lv in levels) / len(traced)
