"""Parity of the port's photometric model helpers (samplers, problem
set-up, image pyramid) and synthetic generator with the JAX package, on
numpy-seeded inputs.  Float32 throughout, as the solve runs; the sampler
and pyramid share the reference's arithmetic, so they agree to f32
rounding (rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.models import photometric_ba as jpba
from photometric_bundle_adjustment_tpu.models import synthetic as jsyn
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as tpba
from photometric_bundle_adjustment_tpu_torch.models import synthetic as tsyn

torch.set_num_threads(1)

H, W, K = 24, 40, 3


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 255, (K, H, W)).astype(np.float32)


def _uv(n=200, seed=1):
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(-3, W + 2, n), rng.uniform(-3, H + 2, n)], -1)
    uv[:4] = [[0.0, 0.0], [W - 1.001, H - 1.001], [W - 1.0, 5.0], [3.5, -0.5]]
    return uv.astype(np.float32)


def test_bilinear_samplers_match_jax(images):
    uv = _uv()
    idx = np.random.default_rng(2).integers(0, K, uv.shape[0])
    flat = images.reshape(-1)
    ref_v = jpba.bilinear_sample_flat(jnp.asarray(flat), jnp.asarray(idx),
                                      jnp.asarray(uv), H, W)
    port_v = tpba.bilinear_sample_flat(torch.as_tensor(flat),
                                       torch.as_tensor(idx),
                                       torch.as_tensor(uv), H, W)
    np.testing.assert_allclose(_np(port_v), _np(ref_v), rtol=1e-5, atol=1e-3)
    ref = jpba.bilinear_sample_and_grad(jnp.asarray(flat), jnp.asarray(idx),
                                        jnp.asarray(uv), H, W)
    port = tpba.bilinear_sample_and_grad(torch.as_tensor(flat),
                                         torch.as_tensor(idx),
                                         torch.as_tensor(uv), H, W)
    for name, a, b in zip(["val", "gx", "gy"], port, ref):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-3,
                                   err_msg=name)
    # clamped (off-image) coordinates carry zero gradient
    off_x = (uv[:, 0] < 0) | (uv[:, 0] > W - 1.001)
    assert off_x.any() and (_np(port[1])[off_x] == 0).all()


def test_extract_ref_patches_matches_jax(images):
    uv = _uv(40, seed=3)
    idx = np.arange(40) % K
    flat = images.reshape(-1)
    ref = jpba.extract_ref_patches(jnp.asarray(flat), jnp.asarray(idx),
                                   jnp.asarray(uv), H, W)
    port = tpba.extract_ref_patches(torch.as_tensor(flat),
                                    torch.as_tensor(idx),
                                    torch.as_tensor(uv), H, W)
    assert port.shape == (40, tpba.PATCH_SIZE)
    np.testing.assert_allclose(_np(port), _np(ref), rtol=1e-5, atol=1e-3)


def test_pyramid_matches_jax(images):
    ref = jpba.build_pyramid(jnp.asarray(images), 3)
    port = tpba.build_pyramid(torch.as_tensor(images), 3)
    assert [(h, w) for _, h, w in port] == [(h, w) for _, h, w in ref]
    assert [(h, w) for _, h, w in port] == [(24, 40), (12, 20), (6, 10)]
    for (a, _, _), (b, _, _) in zip(port, ref):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6)
    np.testing.assert_allclose(
        _np(tpba.downsample2(torch.as_tensor(images[:, :23, :39]))),
        _np(jpba.downsample2(jnp.asarray(images[:, :23, :39]))), rtol=1e-6)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_scale_problem_to_level_matches_jax(level):
    problem, *_ = jsyn.synth_pba_problem(K=4, L=16, dtype=jnp.float32)
    tproblem = interop.problem_from_numpy(problem, "cpu")
    ref = jpba.scale_problem_to_level(problem, level).obs.aux
    port = tpba.scale_problem_to_level(tproblem, level).obs.aux
    for name in ("uv_ref", "intr_ref", "intr_target"):
        np.testing.assert_allclose(_np(getattr(port, name)),
                                   _np(getattr(ref, name)), rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(
        _np(tpba.scale_intrinsics(tproblem.obs.aux.intr_ref, level)),
        _np(jpba.scale_intrinsics(problem.obs.aux.intr_ref, level)),
        rtol=1e-6)


def test_cam_retract_matches_jax():
    problem, *_ = jsyn.synth_pba_problem(K=4, L=16, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    delta = rng.normal(0, 0.01, (4, 8)).astype(np.float32)
    cams = problem.cam_states._replace(
        affine=jnp.asarray(rng.normal(0, 0.1, (4, 2)), jnp.float32))
    ref = [jpba.cam_retract(jpba.PhotometricCams(cams.pose[k], cams.affine[k]),
                            jnp.asarray(delta[k])) for k in range(4)]
    port = tpba.cam_retract(
        tpba.PhotometricCams(torch.as_tensor(np.array(cams.pose)),
                             torch.as_tensor(np.array(cams.affine))),
        torch.as_tensor(delta))
    np.testing.assert_allclose(_np(port.pose),
                               np.stack([_np(r.pose) for r in ref]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(port.affine),
                               np.stack([_np(r.affine) for r in ref]),
                               rtol=1e-6, atol=1e-7)


def test_synth_pba_problem_matches_jax():
    ref = jsyn.synth_pba_problem(K=4, L=32, seed=3, dtype=jnp.float32)
    port = tsyn.synth_pba_problem(K=4, L=32, seed=3, device="cpu")
    jp, jimg, jH, jW, jposes, jrho = ref
    tp, timg, tH, tW, tposes, trho = port
    assert (tH, tW) == (jH, jW)
    np.testing.assert_allclose(_np(timg), _np(jimg), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(_np(tposes), _np(jposes), atol=1e-6)
    np.testing.assert_allclose(_np(trho), _np(jrho), rtol=1e-5)
    np.testing.assert_allclose(_np(tp.cam_states.pose),
                               _np(jp.cam_states.pose), atol=1e-6)
    np.testing.assert_allclose(_np(tp.inv_depth), _np(jp.inv_depth),
                               rtol=1e-5)
    for name in ("uv_ref", "ref_patch", "intr_ref", "intr_target"):
        np.testing.assert_allclose(_np(getattr(tp.obs.aux, name)),
                                   _np(getattr(jp.obs.aux, name)),
                                   rtol=1e-4, atol=1e-2, err_msg=name)
    for name in ("anchor_cam", "target_cam", "landmark", "valid"):
        np.testing.assert_array_equal(_np(getattr(tp.obs, name)),
                                      _np(getattr(jp.obs, name)))
    np.testing.assert_array_equal(_np(tp.fixed_cams), _np(jp.fixed_cams))


def test_synth_pba_pipe_shape_and_tail():
    pipe = tsyn.synth_pba_pipe(K=24, L=60, obs_per_lm=3, long_tracks=6,
                               seed=1)
    assert len(pipe.cameras) == len(pipe.images) == 24
    assert all(img.shape == (64, 96) and img.dtype == np.uint8
               for img in pipe.images.values())
    n_obs = [len(lm.obs) for lm in pipe.landmarks.values()]
    assert max(n_obs) > 4 * 3 and min(n_obs) >= 2
    for lm in pipe.landmarks.values():
        a = lm.anchor()
        assert a == min(lm.obs)
        assert pipe.corners[a]["uv"].shape[1] == 2
    # frame 0 is the gauge: unperturbed
    for key in [(0, 0), (0, 1)]:
        np.testing.assert_array_equal(pipe.cameras[key], pipe.poses_gt[key])
    assert any(np.abs(pipe.cameras[k] - pipe.poses_gt[k]).max() > 0
               for k in pipe.cameras)
