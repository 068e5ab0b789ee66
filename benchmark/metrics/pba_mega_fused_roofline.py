"""Kernel #1's share of its roofline, %: the least bytes its launches in
the traced requests must read (``roofline.mega_bytes`` per pyramid level,
one launch per build, builds = tries + 1 per level) at 3.35 TB/s, over
the device time of the kernels named ``mega_kernel`` in the trace."""

from benchmark import roofline


def read(run):
    if run.trace is None or not run.launch_bytes:
        return None
    t = run.trace.kernel_seconds("mega_kernel")
    if t <= 0:
        return None
    need = 0
    for out, per_level in zip(run.outputs[:run.traced], run.launch_bytes):
        for lv, nbytes in zip(out["levels"], per_level):
            need += (lv["tries"] + 1) * nbytes
    return 100.0 * need / roofline.H100_BYTES_PER_S / t
