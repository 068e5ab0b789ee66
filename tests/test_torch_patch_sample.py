"""Parity of the port's patch sampler (ops/patch_sample.py) with the JAX
package's: the plain PyTorch version on observation columns against the
Pallas kernel (interpret mode on the CPU) on its group layout, and against
the gather sampler ``bilinear_sample_and_grad``.

The JAX kernel takes observations sorted by target image in 128-row
groups (its ``group_layout``); the port's sampler takes each column's own
image, so the JAX outputs are permuted from group order to observation
columns through the JAX package's own layout.  The Pallas kernel samples
through its tile contraction on coordinates relative to a quantised
window, so it agrees with exact bilinear sampling to f32 association
order: rtol 1e-3 / atol 1e-3 on grey values, the JAX package's own
tile-vs-gather tolerance (tests/test_photometric_ba.py).  The port's plain
version and the gather sampler share their arithmetic (rtol 1e-5).  Points
beyond the kernel's window (past about 3x patch stretch) are where the two
kernels differ on purpose: the port samples the image exactly there.
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
N_ZERO = 3               # zero columns (image -1) after the observations


def _layout_case(kind):
    rng = np.random.default_rng(1)
    if kind == "empty_images":      # images 2 and 4 of 6 have no observation
        return rng.choice([0, 1, 3, 5], 400), 6
    if kind == "exact_multiples":   # 256 and 128 rows: no padding slot
        return np.r_[np.zeros(256, int), np.full(128, 2)], 3
    return rng.integers(0, 5, 1000), 5


def _group_of_obs(order):
    g = np.full(order.max() + 1, -1)
    g[order[order >= 0]] = np.flatnonzero(order >= 0)
    return g


def _points(rng, O, w=W, h=H):
    """Patch points clustered around one centre per column."""
    base = np.stack([rng.uniform(3, w - 4, O), rng.uniform(3, h - 4, O)])
    ux = base[0][None] + rng.uniform(-2.5, 2.5, (tps.P, O))
    uy = base[1][None] + rng.uniform(-2.5, 2.5, (tps.P, O))
    return ux.astype(np.float32), uy.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "empty_images",
                                  "exact_multiples"])
def test_sampler_columns_match_jax_group_layout(kind):
    """The plain sampler on observation columns gives, column for column,
    what it gives on the JAX package's group layout (each group row
    sampling its group's image, padding rows zero columns), bit for bit."""
    target_img, n_images = _layout_case(kind)
    order, iog, cnt = jps.group_layout(target_img, n_images)
    rng = np.random.default_rng(2)
    images = torch.as_tensor(
        rng.uniform(0, 255, (n_images, H, W)).astype(np.float32))
    ux, uy = (torch.as_tensor(a) for a in _points(rng, target_img.size))
    img = torch.as_tensor(target_img, dtype=torch.int32)
    port = tps.sample_patches(images, ux, uy, img, (H, W))
    take = torch.as_tensor(np.where(order >= 0, order, 0))
    lane = np.arange(order.size) % jps.GROUP
    img_g = np.where(lane < np.repeat(cnt, jps.GROUP),
                     np.repeat(iog, jps.GROUP), -1)
    group = tps.sample_patches(images, ux[:, take], uy[:, take],
                               torch.as_tensor(img_g, dtype=torch.int32),
                               (H, W))
    g = torch.as_tensor(_group_of_obs(order))
    for a, b in zip(port, group):
        assert torch.equal(a, b[:, g])
        assert (b[:, torch.as_tensor(img_g < 0)] == 0).all()


@pytest.fixture(scope="module")
def case():
    """Observation columns of three images, in shuffled order, with
    clustered patch points (inside the TPU kernel's window), one column
    stretched across the image, N_ZERO zero columns after them, and the
    JAX kernel's output on its group layout permuted to the columns, for
    both ``want_grads`` settings."""
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (KIMG, H, W)).astype(np.float32)
    target_img = rng.permutation(np.repeat(np.arange(KIMG), COUNTS))
    O = target_img.size
    ux, uy = _points(rng, O + N_ZERO)
    uy[:, STRETCHED] = np.linspace(4.0, 50.0, tps.P)
    order, iog, cnt = jps.group_layout(target_img, KIMG)
    take = np.where(order >= 0, order, 0)
    pad, HW = jps.pad_images(jnp.asarray(images))
    g = _group_of_obs(order)
    jax_out = {}
    for wg in (True, False):
        jax_out[wg] = [np.asarray(a)[:, g] for a in jps.sample_patches_grouped(
            pad, jnp.asarray(ux[:, take]), jnp.asarray(uy[:, take]),
            jnp.asarray(iog), jnp.asarray(cnt), HW=HW, want_grads=wg,
            interpret=True)]
    img = np.r_[target_img, np.full(N_ZERO, -1)].astype(np.int32)
    return SimpleNamespace(images=images, ux=ux, uy=uy, img=img, O=O,
                           jax=jax_out)


def _port(case, want_grads, ux=None, uy=None):
    t = torch.as_tensor
    out = tps.sample_patches(
        t(case.images), t(case.ux if ux is None else ux),
        t(case.uy if uy is None else uy), t(case.img), (H, W), want_grads)
    return [a.numpy() for a in out]


@pytest.mark.parametrize("want_grads", [True, False])
def test_plain_sampler_matches_jax_kernel(case, want_grads):
    port = _port(case, want_grads)
    cols = np.ones(case.O, bool)
    cols[STRETCHED] = False
    for name, a, b in zip(["val", "gx", "gy"], port, case.jax[want_grads]):
        assert a.shape == (tps.P, case.O + N_ZERO)
        np.testing.assert_allclose(a[:, :case.O][:, cols], b[:, cols],
                                   rtol=1e-3, atol=1e-3, err_msg=name)
        # zero columns are exact zeros
        assert (a[:, case.O:] == 0).all(), name
    if not want_grads:
        assert not port[1].any() and not port[2].any()


def _gather(case, ux, uy):
    """The JAX gather sampler at each column's image (image 0 for the
    zero columns)."""
    img = np.maximum(case.img, 0)[None, :] * np.ones((tps.P, 1), int)
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
    v = slice(0, case.O)
    for name, a, b in zip(["val", "gx", "gy"], port, ref):
        np.testing.assert_allclose(a[:, v], b[:, v], rtol=1e-5, atol=1e-4,
                                   err_msg=name)
    assert port[0][0, 30] == case.images[case.img[30], 0, 0]
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
    meta = torch.empty((tps.P, 16), device="meta")
    idx = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tps.sample_patches(torch.empty((1, 4, 4), device="meta"), meta, meta,
                           idx, (4, 4))
