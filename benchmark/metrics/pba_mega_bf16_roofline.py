"""Kernel #1's bf16 tier's share of its roofline, %: the least bytes its
launches in the traced requests must read (the bf16 driver's
``launch_bytes``: 2 bytes a texel; one launch per build, builds = tries +
1 per level) at 3.35 TB/s, over the device time of the kernel's bf16
instantiation in the trace (the profiler names it
``(anonymous namespace)::mega_kernel<MODEL, __nv_bfloat16>(...)``)."""

from benchmark import roofline


def read(run):
    if run.trace is None or not run.launch_bytes:
        return None
    t = sum(e - s for n, s, e in run.trace.kernels
            if "mega_kernel<" in n and "__nv_bfloat16" in n) / 1e6
    if t <= 0:
        return None
    need = 0
    for out, per_level in zip(run.outputs[:run.traced], run.launch_bytes):
        for lv, nbytes in zip(out["levels"], per_level):
            need += (lv["tries"] + 1) * nbytes
    return 100.0 * need / roofline.H100_BYTES_PER_S / t
