"""Roofline accounting on the H100: the card's peaks and the share of
them a measured time reaches.

Port of ``photometric_bundle_adjustment_tpu/utils/roofline.py`` with the
NVIDIA H100 SXM's published peaks (at 700 W) in place of the TPU's.  The
port counts a kernel's bytes and operations from its inputs (each input
read once, each output written once), as ``chip_smoke.py``'s bounds do;
the JAX package's ``xla_cost``/``jit_cost`` read XLA's cost model and have
no counterpart.  The data sheet gives no rate for b1 tensor-core
products: ``mma_rates`` measures it on the card (``csrc/mma_rate.cu``).

The bounds of the port's kernels are counted here from their inputs, so
that every caller (``chip_smoke.py``, ``bench.py``) charges the same work
whatever implements it: ``mega_bound_ms`` (the megakernel, #1),
``sample_bound_ms`` (the patch sampler, #2), ``hamming_bound_ms`` (the
Hamming best-two, #3, at the b1 rate ``mma_rates`` measures), and
``schur_step_ops`` for a fixed LM step's Schur Gram and Cholesky.  Each
bound takes ``log``, a callable given the counts as one line of text, or
None for silence.
"""

from __future__ import annotations

import torch

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


# megakernel f32 operations per observation, counted from
# csrc/pba_mega.cu: about 150 for the two rotations, M and u; per patch
# pixel about 12 for q, up to 60 for the projection and its Jacobian
# (kb4), 58 for the 26 coefficients, 26 for J = gx GA + gy GB, 40 for the
# bilinear value and gradient and 10 for the residual (8 pixels: about
# 1,650), plus about 550 for the payloads A0 and A1; rounded up
MEGA_OPS_PER_OBS = 4096


def _require_bytes(ops: float, nbytes: float, what: str):
    if not ops / H100_F32_OPS_PER_S < nbytes / H100_BYTES_PER_S:
        raise RuntimeError(f"{what} bound is not bytes")


def mega_bound_ms(model, images, cams, rho, consts, log=None) -> float:
    """Least time of one megakernel build on these inputs, counted from the
    fused entry's own inputs: the bytes it must move (each observation
    column's static columns (index 16 B, bearings 96 B, intrinsics 32 B,
    reference patch 32 B) read once, the state (poses, affine, inverse
    depths) read once, each image pixel its taps touch read once at the
    stack's 4 or 2 bytes, and the (184,) f32 payload of each observation
    written once; zero columns are not charged) over the card's memory
    rate.  Its f32 operations (MEGA_OPS_PER_OBS each) take far less, so it
    is bytes-bound."""
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega

    K, H, W = images.shape
    ok = consts.timg >= 0
    n_obs = int(ok.sum())
    ux, uy, _, _, _ = pba_mega.warp_slabs(model, cams, rho, consts)
    img = consts.timg[ok]
    x0 = torch.floor(ux[:, ok].clamp(0, W - 1.001)).long()
    y0 = torch.floor(uy[:, ok].clamp(0, H - 1.001)).long()
    taps = torch.cat([((img * H + y0 + dy) * W + x0 + dx).reshape(-1)
                      for dy in (0, 1) for dx in (0, 1)])
    n_pix = int(torch.unique(taps).numel())
    texel = images.element_size()
    col_bytes = 4 * (4 + 3 * pba_mega.P + 8 + pba_mega.P)
    state = 4 * (cams.pose.numel() + cams.affine.numel() + rho.numel())
    out_bytes = 4 * pba_mega.OUT_ROWS * n_obs
    nbytes = col_bytes * n_obs + state + texel * n_pix + out_bytes
    _require_bytes(MEGA_OPS_PER_OBS * n_obs, nbytes, "megakernel")
    if log is not None:
        log(f"  bound: {nbytes / 1e6:.2f} MB ({n_obs} observations x "
            f"{col_bytes} B of columns, state {state / 1e6:.3f} MB, {n_pix} "
            f"image pixels x {texel} B, output {out_bytes / 1e6:.2f} MB) at "
            f"3.35 TB/s")
    return 1e3 * nbytes / H100_BYTES_PER_S


def sample_bound_ms(images, ux, uy, img, log=None) -> float:
    """Least time of one sampler call on these inputs: the bytes it must
    move (ux, uy and the image index of each observation column, each
    image pixel its taps touch read once, 3 x 8 f32 per observation
    written once; zero columns are not charged) over the card's memory
    rate.  Its f32 operations (about 20 per point) take far less, so it is
    bytes-bound."""
    from photometric_bundle_adjustment_tpu_torch.ops import patch_sample as ps

    K, H, W = images.shape
    ok = img >= 0
    n_obs = int(ok.sum())
    im = img[ok].long()
    x0 = torch.floor(ux[:, ok].clamp(0, W - 1.001)).long()
    y0 = torch.floor(uy[:, ok].clamp(0, H - 1.001)).long()
    taps = torch.cat([((im * H + y0 + dy) * W + x0 + dx).reshape(-1)
                      for dy in (0, 1) for dx in (0, 1)])
    n_pix = int(torch.unique(taps).numel())
    out_bytes = 4 * 3 * ps.P * n_obs
    nbytes = 4 * (2 * ps.P * n_obs + n_obs + n_pix) + out_bytes
    _require_bytes(20 * ps.P * n_obs, nbytes, "sampler")
    if log is not None:
        log(f"  bound: {nbytes / 1e6:.2f} MB ({n_obs} observations x "
            f"{8 * ps.P + 4} B, {n_pix} image pixels, output "
            f"{out_bytes / 1e6:.2f} MB) at 3.35 TB/s")
    return 1e3 * nbytes / H100_BYTES_PER_S


def hamming_bound_ms(valid, a, b, F, b1_rate, log=None) -> tuple[float, str]:
    """Least time of the all-pairs best-two (both directions) on these
    inputs: the larger of the bytes (the descriptors and masks of each
    image the pairs touch and the pair indices read once, three (P, F)
    int32 outputs per direction written once) over the memory rate, and
    the operations of one 256-term product per pair between its valid
    descriptors (2 x 256 per distance; one product serves both
    directions) over the faster of the two routes: int8 bit planes at the
    data sheet's peak, or b1 words at ``b1_rate`` (the sustained rate
    ``mma_rates`` measures on the card).  Returns (ms, "operations" or
    "bytes")."""
    n = valid.sum(1).double()
    P = a.numel()
    ops = float((n[a] * n[b]).sum()) * 256 * 2
    touched = int(torch.unique(torch.cat([a.reshape(-1), b.reshape(-1)]))
                  .numel())
    nbytes = (touched * valid.shape[1] * (32 + 1) + 2 * 2 * 4 * P
              + 2 * 3 * 4 * P * F)
    t_int8, t_b1 = ops / H100_INT8_OPS_PER_S, ops / b1_rate
    t_ops, t_bytes = min(t_int8, t_b1), nbytes / H100_BYTES_PER_S
    if log is not None:
        log(f"  bound: {ops:.3e} operations ({1e3 * t_int8:.4f} ms as int8 "
            f"at 1,979 TOP/s, {1e3 * t_b1:.4f} ms as b1 at the measured "
            f"{b1_rate / 1e12:.1f}), {nbytes / 1e6:.1f} MB over {touched} "
            f"images ({1e3 * t_bytes:.4f} ms at 3.35 TB/s)")
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def mma_rates(device, log=None) -> dict:
    """The card's sustained mma.sync rate, in operations per second, of
    the b1 AND+POPC form (the Hamming kernel's product) and the s8 form:
    ``csrc/mma_rate.cu`` at 4 blocks of 8 warps per SM, the best of 3
    launches of each timed with CUDA events after one warm-up.  Returns
    {"b1": rate, "s8": rate}."""
    import ctypes

    from photometric_bundle_adjustment_tpu_torch.ops import _build

    fn = _build.load("mma_rate").mma_rate
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    blocks = 4 * torch.cuda.get_device_properties(device).multi_processor_count
    sink = torch.empty(blocks * 256, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    ops = ctypes.c_longlong()
    rates = {}
    for form, (code, iters) in {"b1": (0, 2048), "s8": (1, 8192)}.items():
        def run():
            err = fn(code, blocks, iters, sink.data_ptr(), ctypes.byref(ops),
                     stream)
            if err != 0:
                raise RuntimeError(f"mma_rate {form} failed to launch ({err})")
        run()
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        rates[form] = ops.value / (min(times) / 1e3)
        if log is not None:
            log(f"  mma.sync {form}: {rates[form] / 1e12:.1f} TOP/s sustained "
                f"({ops.value:.3e} operations in {min(times):.4f} ms, best "
                f"of 3; the data sheet's dense int8 peak, for wgmma, is "
                f"1,979)")
    return rates


def schur_step_ops(n_landmarks: int, n_cam_unknowns: int) -> tuple[float, float]:
    """f32 operations of a fixed LM step's two dense products, counted
    from its shapes: the Schur Gram M^T M of the (L, n) landmark-camera
    coupling, 2 L n^2 as computed (both triangles), and the Cholesky
    factor of the (n, n) damped reduced system, n^3 / 3.  Returns
    (gram, cholesky)."""
    n = float(n_cam_unknowns)
    return 2.0 * n_landmarks * n * n, n ** 3 / 3.0
