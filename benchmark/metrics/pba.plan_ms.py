"""Host milliseconds a traced refinement spends in its levels' solver
plans: the levels' ``setup_s`` (the program's ``pba.level.plan`` spans:
the host plans, the kernel's constants and their copies, each ended by a
device sync), summed over the pyramid and averaged over the traced
requests."""


def read(run):
    traced = run.outputs[:run.traced]
    if run.trace is None or not traced:
        return None
    return 1e3 * sum(lv["setup_s"] for o in traced
                     for lv in o["levels"]) / len(traced)
