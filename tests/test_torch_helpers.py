"""Slice E's small helpers and kb4 unprojection's derivative, against the
JAX package on the CPU in f64.

kb4: the port's ``cameras._kb4_theta_from_ru`` is a
``torch.autograd.Function`` with the implicit-function derivative of the
JAX package's ``custom_jvp``.  Its Jacobians in the parameters and in
the pixel (``torch.func.jacfwd`` against ``jax.jacfwd``) agree within
1e-9 of max|J| on the input where differentiating the 5 unrolled Newton
steps is off by 2.4e3 (params (200, 200, 376, 240, 0.5, -0.5, 0.8, -0.3),
400 uniform pixels of 752 x 480 from numpy seed 0) and on
tests/data/opt_calib_kb4.json's 48 x 32 grid; its values equal the
unrolled function's bit for bit; ``vmap``, ``jacrev`` and
``autograd.grad`` give the same derivative.

The rest: ``se3.identity``, ``quat_identity``, ``from_matrix``,
``to_matrix``, ``normalize`` and ``cameras.initialize``,
``project_batch`` equal to the JAX package's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.core import cameras as jcameras
from photometric_bundle_adjustment_tpu.core import se3 as jse3
from photometric_bundle_adjustment_tpu.io import calib_io as jcalib_io
from photometric_bundle_adjustment_tpu_torch.core import cameras, se3

torch.set_num_threads(1)

J_RTOL = 1e-9      # times max|J|
FAILING_PARAMS = np.array([200, 200, 376, 240, 0.5, -0.5, 0.8, -0.3])
KB4_JSON = os.path.join(os.path.dirname(__file__), "data", "opt_calib_kb4.json")


def failing_pixels():
    return np.random.default_rng(0).uniform([0, 0], [752, 480], (400, 2))


def grid_pixels():
    xs, ys = np.meshgrid(np.linspace(0, 751, 48), np.linspace(0, 479, 32))
    return np.stack([xs.ravel(), ys.ravel()], 1)


def kb4_cases():
    calib = jcalib_io.load_calibration(KB4_JSON)
    return ([("failing", FAILING_PARAMS, failing_pixels())]
            + [(f"json-cam{c}", calib.intrinsics[c], grid_pixels())
               for c in range(2)])


def unrolled_unproject(params, uv):
    """The port's kb4 unprojection before the autograd Function: the same
    arithmetic, differentiated through its 5 Newton steps."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r2 = mx * mx + my * my
    at_center = r2 == 0.0
    r_u = torch.sqrt(torch.where(at_center, torch.ones_like(r2), r2))
    theta = torch.zeros_like(r_u)
    for _ in range(5):
        theta = theta - (cameras._kb4_dtheta(k, theta) - r_u) / \
            cameras._kb4_ddtheta(k, theta)
    s = torch.sin(theta) / r_u
    x = torch.where(at_center, torch.zeros_like(mx), s * mx)
    y = torch.where(at_center, torch.zeros_like(my), s * my)
    z = torch.where(at_center, torch.ones_like(mx), torch.cos(theta))
    return torch.stack([x, y, z], dim=-1)


@pytest.mark.parametrize("case", kb4_cases(), ids=lambda c: c[0])
def test_kb4_jacobians_match_jax(case):
    _, params, uv = case
    J_j = np.asarray(jax.jacfwd(
        lambda p: jcameras.kb4_unproject(p, jnp.asarray(uv)))(
            jnp.asarray(params)))
    J_t = torch.func.jacfwd(
        lambda p: cameras.kb4_unproject(p, torch.as_tensor(uv)))(
            torch.as_tensor(params)).numpy()
    np.testing.assert_allclose(J_t, J_j, rtol=0,
                               atol=J_RTOL * np.abs(J_j).max())
    # in the pixel, per point
    Ju_j = np.asarray(jax.vmap(jax.jacfwd(
        lambda u: jcameras.kb4_unproject(jnp.asarray(params), u)))(
            jnp.asarray(uv)))
    Ju_t = torch.func.vmap(torch.func.jacfwd(
        lambda u: cameras.kb4_unproject(torch.as_tensor(params), u)))(
            torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(Ju_t, Ju_j, rtol=0,
                               atol=J_RTOL * np.abs(Ju_j).max())


def test_unrolled_derivative_is_wrong_on_the_failing_input():
    """Where 5 Newton steps have not converged, the unrolled derivative
    is not the implicit one (the fault the Function repairs)."""
    uv = torch.as_tensor(failing_pixels())
    p = torch.as_tensor(FAILING_PARAMS)
    J_new = torch.func.jacfwd(lambda q: cameras.kb4_unproject(q, uv))(p)
    J_old = torch.func.jacfwd(lambda q: unrolled_unproject(q, uv))(p)
    assert float((J_new - J_old).abs().max()) > 1e2


@pytest.mark.parametrize("case", kb4_cases(), ids=lambda c: c[0])
def test_kb4_values_bit_equal_to_unrolled(case):
    _, params, uv = case
    for dtype in (torch.float64, torch.float32):
        p = torch.as_tensor(params, dtype=dtype)
        u = torch.as_tensor(uv, dtype=dtype)
        assert torch.equal(cameras.kb4_unproject(p, u),
                           unrolled_unproject(p, u))


def test_kb4_function_under_vmap_jacrev_and_grad():
    uv = torch.as_tensor(failing_pixels())
    p = torch.as_tensor(FAILING_PARAMS)

    def f(q):
        return cameras.kb4_unproject(q, uv)

    J_fwd = torch.func.jacfwd(f)(p)
    J_rev = torch.func.jacrev(f)(p)
    torch.testing.assert_close(J_rev, J_fwd, rtol=0,
                               atol=J_RTOL * float(J_fwd.abs().max()))
    q = p.clone().requires_grad_()
    (g,) = torch.autograd.grad(f(q).sum(), q)
    torch.testing.assert_close(g, J_fwd.sum((0, 1)), rtol=1e-12, atol=1e-9)
    # a batch of parameter vectors under vmap, and per-pixel jacrev
    P = torch.stack([p, p * 1.01])
    out = torch.func.vmap(f)(P)
    assert torch.equal(out[0], f(p)) and torch.equal(out[1], f(P[1]))
    Jb = torch.func.vmap(torch.func.jacrev(f))(P)
    torch.testing.assert_close(Jb[0], J_rev)
    # a pixel at the centre has no derivative from theta
    c = torch.tensor([[376.0, 240.0]], dtype=torch.float64)
    Jc = torch.func.jacfwd(lambda q: cameras.kb4_unproject(q, c))(p)
    assert bool(torch.isfinite(Jc).all())


def test_se3_helpers_match_jax():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.7, (5, 6))
    T = se3.exp(torch.as_tensor(xi))
    T_j = jse3.exp(jnp.asarray(xi))
    assert torch.equal(se3.identity(), torch.as_tensor(
        np.array(jse3.identity())))
    assert torch.equal(se3.quat_identity(torch.float32), torch.as_tensor(
        np.array(jse3.quat_identity(jnp.float32))))
    M = se3.to_matrix(T)
    np.testing.assert_allclose(M.numpy(), np.asarray(jse3.to_matrix(T_j)),
                               rtol=0, atol=1e-15)
    assert M.shape == (5, 4, 4)
    np.testing.assert_allclose(se3.from_matrix(M).numpy(),
                               np.asarray(jse3.from_matrix(jnp.asarray(
                                   M.numpy()))), rtol=0, atol=1e-15)
    np.testing.assert_allclose(se3.from_matrix(M[:, :3]).numpy(), T.numpy(),
                               rtol=0, atol=1e-14)
    scaled = T.clone()
    scaled[:, 3:] *= 1.5
    np.testing.assert_allclose(se3.normalize(scaled).numpy(),
                               np.asarray(jse3.normalize(jnp.asarray(
                                   scaled.numpy()))), rtol=0, atol=1e-15)


@pytest.mark.parametrize("model", ["pinhole", "eucm", "ds", "kb4"])
def test_camera_helpers_match_jax(model):
    ds = np.array([351.0, 350.0, 365.9, 249.3, -0.24, 0.57, 0.3, 0.4])
    inp = torch.tensor(ds)
    got = cameras.initialize(model, inp)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcameras.initialize(model, jnp.asarray(ds))))
    assert torch.equal(inp, torch.as_tensor(ds))     # the input unchanged
    pts = np.random.default_rng(1).normal([0, 0, 3], [1, 1, 0.5], (64, 3))
    params = np.asarray(jcameras.test_params(model))
    np.testing.assert_allclose(
        cameras.project_batch(model, torch.as_tensor(params),
                              torch.as_tensor(pts)).numpy(),
        np.asarray(jcameras.project_batch(model, jnp.asarray(params),
                                          jnp.asarray(pts))),
        rtol=1e-13, atol=1e-10)
