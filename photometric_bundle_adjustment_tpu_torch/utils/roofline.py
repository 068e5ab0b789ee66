"""Roofline accounting on the H100: the card's peaks and the share of
them a measured time reaches.

Port of ``photometric_bundle_adjustment_tpu/utils/roofline.py`` with the
NVIDIA H100 SXM's published peaks (at 700 W) in place of the TPU's.  The
port counts a kernel's bytes and operations from its inputs (each input
read once, each output written once), as ``chip_smoke.py``'s bounds do;
the JAX package's ``xla_cost``/``jit_cost`` read XLA's cost model and have
no counterpart.  The data sheet gives no rate for b1 tensor-core
products: ``csrc/mma_rate.cu`` measures it on the card (``chip_smoke.py``
phase 0).
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12        # HBM3
H100_F32_OPS_PER_S = 67e12        # f32 outside the tensor cores
H100_INT8_OPS_PER_S = 1.979e15    # dense int8 tensor-core operations


def bound_ms(flops: float, bytes_: float,
             ops_per_s: float = H100_F32_OPS_PER_S) -> tuple[float, str]:
    """The least time (ms) the card could take for the work, the larger
    of the bytes over the memory rate and the operations over
    ``ops_per_s``, and which of the two binds (``"bytes"`` or
    ``"operations"``)."""
    t_bytes = bytes_ / H100_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline(dt_seconds: float, flops: float, bytes_: float,
             ops_per_s: float = H100_F32_OPS_PER_S) -> dict:
    """Achieved rates, their shares of the peaks, and the binding
    resource: the one whose share is the larger, which must improve for
    the work to go faster.  Under 2% of both peaks the time is launch or
    latency overhead, and ``bound`` says so."""
    ops = flops / dt_seconds / ops_per_s
    mem = bytes_ / dt_seconds / H100_BYTES_PER_S
    if ops < 0.02 and mem < 0.02:
        bound = "latency/overhead"
    else:
        bound = "operations" if ops >= mem else "bytes"
    return {
        "tflops": flops / dt_seconds / 1e12,
        "gbps": bytes_ / dt_seconds / 1e9,
        "pct_ops_peak": 100 * ops,
        "pct_bytes_peak": 100 * mem,
        "bound": bound,
    }
