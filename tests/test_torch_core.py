"""Parity of the PyTorch port's core (se3, cameras, camera_slab) with the
JAX package, in float64 on the same numpy-seeded inputs.  Both compute the
same formulas, so they agree to a few ulps (rtol 1e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.core import camera_slab as jslab
from photometric_bundle_adjustment_tpu.core import cameras as jcam
from photometric_bundle_adjustment_tpu.core import se3 as jse3
from photometric_bundle_adjustment_tpu_torch.core import camera_slab as tslab
from photometric_bundle_adjustment_tpu_torch.core import cameras as tcam
from photometric_bundle_adjustment_tpu_torch.core import se3 as tse3

torch.set_num_threads(1)

MODELS = ["pinhole", "eucm", "ds", "kb4"]
RTOL = 1e-10
ATOL = 1e-12


def _t(x):
    return torch.as_tensor(np.array(x, np.float64))


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _tangents(n=64, seed=0):
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6))
    xi[:, 3:] *= 0.8
    xi[:4, 3:] *= 1e-5          # small-angle branches
    xi[4, 3:] = 0.0
    return xi


def _points(n=200, seed=1):
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.5, 10.0, size=n)
    r = z * np.tan(0.8) * rng.uniform(0, 1, size=n)
    ang = rng.uniform(0, 2 * np.pi, size=n)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang), z], axis=-1)
    pts[0, :2] = 0.0            # the optical axis (kb4's r == 0 branch)
    return pts


@pytest.mark.parametrize("fn", ["exp", "log", "compose", "inverse",
                                "right_plus", "quat_to_matrix"])
def test_se3_matches_jax(fn):
    xi = _tangents()
    xi2 = _tangents(seed=3) * 0.1
    T = np.asarray(jse3.exp(jnp.asarray(xi)))
    T2 = np.asarray(jse3.exp(jnp.asarray(xi2)))
    if fn == "exp":
        port, ref = tse3.exp(_t(xi)), jse3.exp(jnp.asarray(xi))
    elif fn == "log":
        port, ref = tse3.log(_t(T)), jse3.log(jnp.asarray(T))
    elif fn == "compose":
        port = tse3.compose(_t(T), _t(T2))
        ref = jse3.compose(jnp.asarray(T), jnp.asarray(T2))
    elif fn == "inverse":
        port, ref = tse3.inverse(_t(T)), jse3.inverse(jnp.asarray(T))
    elif fn == "right_plus":
        port = tse3.right_plus(_t(T), _t(xi2))
        ref = jse3.right_plus(jnp.asarray(T), jnp.asarray(xi2))
    else:
        q = T[:, 3:]
        port, ref = tse3.quat_to_matrix(_t(q)), jse3.quat_to_matrix(
            jnp.asarray(q))
    _close(port, ref)


def test_se3_accessors_and_act():
    T = np.asarray(jse3.exp(jnp.asarray(_tangents())))
    pts = _points(64)
    _close(tse3.translation(_t(T)), jse3.translation(jnp.asarray(T)))
    _close(tse3.rotation(_t(T)), jse3.rotation(jnp.asarray(T)))
    _close(tse3.act(_t(T), _t(pts)), jse3.act(jnp.asarray(T),
                                              jnp.asarray(pts)))


@pytest.mark.parametrize("model", MODELS)
def test_cameras_match_jax(model):
    params = np.asarray(jcam.test_params(model))
    pts = _points()
    _close(tcam.project(model, _t(params), _t(pts)),
           jcam.project(model, jnp.asarray(params), jnp.asarray(pts)))
    cx, cy = params[2], params[3]
    rng = np.random.default_rng(2)
    uv = np.stack([cx + rng.uniform(-200, 200, 100),
                   cy + rng.uniform(-200, 200, 100)], -1)
    uv[0] = [cx, cy]            # the principal point (kb4's r == 0 branch)
    _close(tcam.unproject(model, _t(params), _t(uv)),
           jcam.unproject(model, jnp.asarray(params), jnp.asarray(uv)))
    _close(tcam.unproject_unit(model, _t(params), _t(uv)),
           jcam.unproject_unit(model, jnp.asarray(params), jnp.asarray(uv)))


@pytest.mark.parametrize("model", MODELS)
def test_camera_slab_matches_jax(model):
    pts = _points(64, seed=5)
    params = np.asarray(jcam.test_params(model))
    intr = np.tile(params[:, None], (1, pts.shape[0]))
    planes = [pts[None, :, i] for i in range(3)]
    port = tslab.project_slab(model, _t(intr), *map(_t, planes))
    ref = jslab.project_slab(model, jnp.asarray(intr),
                             *map(jnp.asarray, planes))
    port_flat = [port[0], port[1], *port[2], *port[3]]
    ref_flat = [ref[0], ref[1], *ref[2], *ref[3]]
    for a, b in zip(port_flat, ref_flat):
        _close(a.expand(b.shape), b, atol=1e-9)


def test_unknown_camera_model_raises():
    with pytest.raises(ValueError, match="not implemented"):
        tcam.project("fisheye9", _t(np.zeros(8)), _t(np.ones(3)))
    with pytest.raises(ValueError, match="not implemented"):
        tslab.project_slab("fisheye9", _t(np.zeros((8, 1))),
                           *[_t(np.ones((1, 1)))] * 3)
