"""The port's photometric solve end to end: parity of ``refine_photometric``
with the JAX package's on one synthetic map, and the guards around it (no
JAX import, the CPU plain path on a wide image, no silent device
fallback), and the profiling entry point on the plain path."""

import copy
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.pipeline import pba_refine as jrefine
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine

torch.set_num_threads(1)


def test_refine_photometric_matches_jax():
    """Both packages refine deep copies of one map (2 levels, 3 iterations
    each).  The JAX package runs its CPU path (gather sampler, classic LM
    loop), the port its megakernel chunk family; accept sequences may
    differ by rounding, so only costs and the final poses are compared.
    L=144 rather than 48: with 48 landmarks the 80 free camera unknowns are
    so weakly constrained that f32 rounding alone moves the two packages'
    poses up to 3e-4 apart."""
    pipe = synthetic.synth_pba_pipe(K=12, L=144, H=64, W=96, obs_per_lm=3,
                                    long_tracks=6, seed=0)
    pipe_j, pipe_t = copy.deepcopy(pipe), copy.deepcopy(pipe)
    lines = []
    res_j = jrefine.refine_photometric(pipe_j, levels=2, max_iterations=3,
                                       log=lines.append)
    res_t = pba_refine.refine_photometric(pipe_t, levels=2, max_iterations=3,
                                          log=lambda s: None, device="cpu")

    init_j = [float(re.search(r"cost (\S+) ->", s).group(1))
              for s in lines if s.startswith("  pba level")]
    init_t = [lv["initial_cost"] for lv in pipe_t.photometric_levels]
    assert [lv["level"] for lv in pipe_t.photometric_levels] == [1, 0]
    np.testing.assert_allclose(init_t, init_j, rtol=2e-4)
    np.testing.assert_allclose(float(res_t.initial_cost),
                               float(res_j.initial_cost), rtol=2e-4)
    np.testing.assert_allclose(float(res_t.cost), float(res_j.cost),
                               rtol=5e-3)
    assert float(res_t.cost) < float(res_t.initial_cost)
    for lv in pipe_t.photometric_levels:
        assert lv["cost"] < lv["initial_cost"] and lv["iterations"] > 0
    keys = sorted(pipe.cameras)
    np.testing.assert_allclose(
        np.stack([pipe_t.cameras[k] for k in keys]),
        np.stack([pipe_j.cameras[k] for k in keys]), atol=1e-4)
    for k in keys:
        np.testing.assert_allclose(pipe_t.photometric_affine[k],
                                   np.asarray(pipe_j.photometric_affine[k]),
                                   atol=1e-3)
    lm = sorted(pipe.landmarks)
    np.testing.assert_allclose(
        [pipe_t.landmarks[j].inv_depth for j in lm],
        [pipe_j.landmarks[j].inv_depth for j in lm], rtol=1e-3)


def test_port_imports_and_solves_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["photometric_bundle_adjustment_tpu"] = None
        import torch
        from photometric_bundle_adjustment_tpu_torch import interop
        from photometric_bundle_adjustment_tpu_torch.core import camera_slab, cameras, se3
        from photometric_bundle_adjustment_tpu_torch.models import synthetic
        from photometric_bundle_adjustment_tpu_torch.ops import _build, pba_mega
        from photometric_bundle_adjustment_tpu_torch.optim import ba, fused, schur_plan
        from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
        torch.set_num_threads(1)
        pipe = synthetic.synth_pba_pipe(K=8, L=32, seed=3)
        res = pba_refine.refine_photometric(pipe, levels=1, max_iterations=2,
                                            log=lambda s: None, device="cpu")
        assert float(res.cost) < float(res.initial_cost), res
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "photometric_bundle_adjustment_tpu"
               or m.startswith("photometric_bundle_adjustment_tpu.")]
        assert all(sys.modules[m] is None for m in bad), bad
        print("OK", float(res.initial_cost), float(res.cost))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_plain_path_wide_image():
    """W=8448 is wider than the TPU kernel's 14-bit column field; the plain
    path must sample it exactly.  On a linear ramp I = a x + b y + c the
    bilinear value is exact and the gradient is (a, b)."""
    H, W, P = 16, 8448, pba_mega.P
    a, b, c = 0.01, 0.5, 10.0
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                            torch.arange(W, dtype=torch.float64),
                            indexing="ij")
    images = (a * xs + b * ys + c).float()[None].repeat(2, 1, 1)
    Og = 2 * pba_mega.GROUP
    rng = np.random.default_rng(0)
    ux = torch.as_tensor(rng.uniform(8000, W - 1.5, (P, Og)), dtype=torch.float32)
    uy = torch.as_tensor(rng.uniform(0.5, H - 1.5, (P, Og)), dtype=torch.float32)
    GA = torch.ones((13 * P, Og))
    GB = torch.zeros((13 * P, Og))
    zeros = torch.zeros
    out = pba_mega.mega_rj(images, ux, uy, GA, GB, zeros((P, Og)),
                           zeros((4, Og)), torch.tensor([0, 1], dtype=torch.int32),
                           torch.tensor([256, 100], dtype=torch.int32), 0.0)
    assert out.shape == (pba_mega.OUT_ROWS, Og)
    valid = (torch.arange(Og) % pba_mega.GROUP) < torch.tensor([256, 100]).repeat_interleave(pba_mega.GROUP)
    assert torch.isfinite(out).all()
    assert (out[:, ~valid] == 0).all()
    ramp = (a * ux.double() + b * uy.double() + c).float()
    # squared loss: sw = 1, r = I(u) - refp = I(u), J_geo = gx = a
    np.testing.assert_allclose(out[136:144, valid].numpy(),
                               ramp[:, valid].numpy(), rtol=2e-6)
    # the gradient is a difference of two f32 taps near 100 (ulp 7.6e-6)
    J = out[:136].reshape(P, 17, Og)
    np.testing.assert_allclose(J[:, 0, valid].numpy(), a, atol=3e-5)
    np.testing.assert_allclose(out[pba_mega.ROW_COST, valid].numpy(),
                               0.5 * (ramp[:, valid].double() ** 2).sum(0).numpy(),
                               rtol=1e-5)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the guard is for hosts without it")
    pipe = synthetic.synth_pba_pipe(K=4, L=8, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pba_refine.refine_photometric(pipe, levels=1, device="cuda")
    with pytest.raises(NotImplementedError, match="sample_bf16"):
        pba_refine.refine_photometric(pipe, sample_bf16=True, device="cpu")
    meta = torch.empty((8, 256), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pba_mega.mega_rj(torch.empty((1, 4, 4), device="meta"), meta, meta,
                         meta, meta, meta, meta, meta, meta, 9.0)


def test_profile_solve_on_plain_path():
    """The profiling entry point runs the level-0 try on the CPU plain path
    and reports every phase; the device fields stay empty off the card."""
    from photometric_bundle_adjustment_tpu_torch import profile_solve

    res = profile_solve.main([
        "--device", "cpu", "--K", "12", "--L", "48", "--H", "64", "--W", "96",
        "--obs-per-lm", "3", "--long-tracks", "4", "--tries", "2",
        "--reps", "2"])
    assert res["K"] == 12 and res["Og"] % pba_mega.GROUP == 0
    assert 0 < res["observations"] <= res["Og"]
    for k in ("build_ms", "warp_slabs_ms", "megakernel_ms", "solve_lam_ms",
              "wall_ms"):
        assert np.isfinite(res[k]) and res[k] > 0, k
    assert res["top_self_ms"] and res["top_by"] == "self_cpu_time_total"
    assert res["device_busy_ms"] is None and res["peak_device_mib"] is None
