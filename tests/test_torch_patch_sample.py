"""Parity of the port's patch sampler (ops/patch_sample.py) with the JAX
package's: the host group layout, the plain PyTorch version against the
Pallas kernel (interpret mode on the CPU) and against the gather sampler
``bilinear_sample_and_grad``.

The Pallas kernel samples through its tile contraction on coordinates
relative to a quantised window, so it agrees with exact bilinear sampling
to f32 association order: rtol 1e-3 / atol 1e-3 on grey values, the JAX
package's own tile-vs-gather tolerance (tests/test_photometric_ba.py).
The port's plain version and the gather sampler share their arithmetic
(rtol 1e-5).  Points beyond the kernel's window (past about 3x patch
stretch) are where the two kernels differ on purpose: the port samples the
image exactly there.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.models import photometric_ba as jpba
from photometric_bundle_adjustment_tpu.ops import patch_sample as jps
from photometric_bundle_adjustment_tpu_torch.ops import patch_sample as tps

torch.set_num_threads(1)

H, W, KIMG = 64, 96, 3
COUNTS = (128, 70, 5)
STRETCHED = 3            # column whose patch spans more than the window


def _layout_case(kind):
    rng = np.random.default_rng(1)
    if kind == "empty_images":      # images 2 and 4 of 6 have no observation
        return rng.choice([0, 1, 3, 5], 400), 6
    if kind == "exact_multiples":   # 256 and 128 rows: no padding slot
        return np.r_[np.zeros(256, int), np.full(128, 2)], 3
    return rng.integers(0, 5, 1000), 5


@pytest.mark.parametrize("kind", ["random", "empty_images",
                                  "exact_multiples"])
def test_group_layout_matches_jax(kind):
    target_img, n_images = _layout_case(kind)
    ref = jps.group_layout(target_img, n_images)
    port = tps.group_layout(target_img, n_images)
    for name, a, b in zip(["order", "img_of_group", "group_counts"], port,
                          ref):
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype, name
    assert port[0].shape[0] % tps.GROUP == 0


@pytest.fixture(scope="module")
def case():
    """Three groups of clustered patch points (inside the TPU kernel's
    window), one column stretched across the image, and the JAX kernel's
    output for both ``want_grads`` settings."""
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (KIMG, H, W)).astype(np.float32)
    Opad = len(COUNTS) * tps.GROUP
    base = np.stack([rng.uniform(3, W - 4, Opad), rng.uniform(3, H - 4, Opad)])
    ux = (base[0][None] + rng.uniform(-2.5, 2.5, (tps.P, Opad))).astype(np.float32)
    uy = (base[1][None] + rng.uniform(-2.5, 2.5, (tps.P, Opad))).astype(np.float32)
    uy[:, STRETCHED] = np.linspace(4.0, 50.0, tps.P)
    iog = np.array([0, 1, 2], np.int32)
    cnt = np.array(COUNTS, np.int32)
    pad, HW = jps.pad_images(jnp.asarray(images))
    jax_out = {}
    for wg in (True, False):
        jax_out[wg] = [np.asarray(a) for a in jps.sample_patches_grouped(
            pad, jnp.asarray(ux), jnp.asarray(uy), jnp.asarray(iog),
            jnp.asarray(cnt), HW=HW, want_grads=wg, interpret=True)]
    lane = np.arange(Opad) % tps.GROUP
    valid = lane < np.repeat(cnt, tps.GROUP)
    return SimpleNamespace(images=images, ux=ux, uy=uy, iog=iog, cnt=cnt,
                           jax=jax_out, valid=valid)


def _port(case, want_grads, ux=None, uy=None):
    t = torch.as_tensor
    out = tps.sample_patches_grouped(
        t(case.images), t(case.ux if ux is None else ux),
        t(case.uy if uy is None else uy), t(case.iog), t(case.cnt), (H, W),
        want_grads)
    return [a.numpy() for a in out]


@pytest.mark.parametrize("want_grads", [True, False])
def test_plain_sampler_matches_jax_kernel(case, want_grads):
    port = _port(case, want_grads)
    cols = case.valid.copy()
    cols[STRETCHED] = False
    for name, a, b in zip(["val", "gx", "gy"], port, case.jax[want_grads]):
        assert a.shape == (tps.P, case.ux.shape[1])
        np.testing.assert_allclose(a[:, cols], b[:, cols], rtol=1e-3,
                                   atol=1e-3, err_msg=name)
        # padding slots are exact zeros (the TPU kernel leaves garbage)
        assert (a[:, ~case.valid] == 0).all(), name
    if not want_grads:
        assert not port[1].any() and not port[2].any()


def _gather(case, ux, uy):
    """The JAX gather sampler at each column's group image."""
    img = np.repeat(case.iog, tps.GROUP)[None, :] * np.ones((tps.P, 1), int)
    return [np.asarray(a) for a in jpba.bilinear_sample_and_grad(
        jnp.asarray(case.images.reshape(-1)), jnp.asarray(img),
        jnp.asarray(np.stack([ux, uy], -1)), H, W)]


def test_plain_sampler_matches_gather_sampler_everywhere(case):
    """Off-image points on every side and a far-out point (-1e6, what the
    callers put in place of a non-finite projection): the clamped value
    and zero gradient, as the gather sampler gives."""
    ux, uy = case.ux.copy(), case.uy.copy()
    ux[:, 10:14] = [-3.0, W + 2.0, W - 1.0005, 0.0]
    uy[:, 20:24] = [-0.5, H + 7.0, H - 1.0005, 0.0]
    ux[:, 30], uy[:, 30] = -1e6, -1e6
    port = _port(case, True, ux, uy)
    ref = _gather(case, ux, uy)
    v = case.valid
    for name, a, b in zip(["val", "gx", "gy"], port, ref):
        np.testing.assert_allclose(a[:, v], b[:, v], rtol=1e-5, atol=1e-4,
                                   err_msg=name)
    assert port[0][0, 30] == case.images[0, 0, 0]
    assert port[1][:, 30].sum() == 0 and port[2][:, 30].sum() == 0
    assert (port[1][:, 10:13] == 0).all() and (port[2][:, 20:23] == 0).all()


def test_stretched_patch_is_exact_where_the_tpu_kernel_clamps(case):
    """A patch spanning 46 rows: the TPU kernel's 24-row window clamps its
    far points, the port samples them exactly (ROADMAP queue 3)."""
    port = _port(case, True)
    ref = _gather(case, case.ux, case.uy)
    kern = case.jax[True]
    c = STRETCHED
    np.testing.assert_allclose(port[0][:, c], ref[0][:, c], rtol=1e-5)
    np.testing.assert_allclose(port[2][:, c], ref[2][:, c], rtol=1e-5,
                               atol=1e-4)
    far = np.abs(kern[0][:, c] - ref[0][:, c]) > 1.0
    assert far.any() and far[-1] and not far[0]


def test_wrapper_rejects_unsupported_device():
    meta = torch.empty((tps.P, tps.GROUP), device="meta")
    idx = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tps.sample_patches_grouped(torch.empty((1, 4, 4), device="meta"),
                                   meta, meta, idx, idx, (4, 4))
