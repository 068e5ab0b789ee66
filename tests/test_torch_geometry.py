"""The port's two-view geometry and minimal solvers against the JAX
package's, on the same numpy-seeded inputs: ``se3.quat_from_matrix``,
``geometry`` (midpoint triangulation, the angular error, the closed-form
essential decomposition, the eight-point solver), Nister's five-point
solver piece by piece and whole (64 samples, slot by slot, the validity
masks equal) and P3P (``quartic_real_roots``, ``p3p_candidates``).  Then
the JAX tests' own properties, on the port alone.

Tolerances: f64 atol 1e-10, and f32 atol 1e-5, for the closed forms;
the triangulated points in f32 to rtol 1e-2 (the 2x2 system is
ill-conditioned at small parallax).  The five-point solver's pivot-free
10x10 elimination amplifies the last bits of its products (the JAX
package's XLA dots and the port's sum in other orders): given the same
input, each piece agrees to rtol 1e-7, and over the 64 samples the
validity masks are equal, 90% of the candidates agree to 1e-10 and all
to 1e-5.  In f32 neither package is accurate (about 15% of the
five-point and 28% of the P3P candidates are more than 1e-3 from the
f64 solution, and a root near a branch or a grid sign change moves
between slots), so the f32 candidates are matched as sets: the port's
find the f64 candidates within 1e-3 and 1e-2 as often as the JAX
package's do, less 3 points, and 90% of the JAX package's have a port
candidate within 1e-2 (five-point up to sign)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.core import se3 as jse3
from photometric_bundle_adjustment_tpu.features import geometry as jgeometry
from photometric_bundle_adjustment_tpu.features import nister as jnister
from photometric_bundle_adjustment_tpu.features import p3p as jp3p
from photometric_bundle_adjustment_tpu_torch.core import se3
from photometric_bundle_adjustment_tpu_torch.features import geometry, nister, p3p

torch.set_num_threads(1)

DTYPES = {"f64": (np.float64, torch.float64, 1e-10),
          "f32": (np.float32, torch.float32, 1e-5)}


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def rotations(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.asarray(jse3.quat_to_matrix(jnp.asarray(q)))


def two_view(n, m, seed):
    """n problems of m correspondences: bearings f0 = T_0_1 p1 and f1 = p1
    of random points 3 to 7 in front, random relative poses; and the
    poses (n, 7)."""
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 0.5, (n, 3)), rng.normal(0, 0.3, (n, 3))],
                        axis=1)
    T = np.asarray(jse3.exp(jnp.asarray(xi)))
    p1 = rng.uniform(-1, 1, (n, m, 3)) + np.array([0, 0, 5.0])
    p0 = np.asarray(jse3.act(jnp.asarray(T)[:, None], jnp.asarray(p1)))
    f0 = p0 / np.linalg.norm(p0, axis=-1, keepdims=True)
    f1 = p1 / np.linalg.norm(p1, axis=-1, keepdims=True)
    return f0, f1, T


@pytest.mark.parametrize("dt", DTYPES)
def test_quat_from_matrix_matches_jax(dt):
    npd, tdt, atol = DTYPES[dt]
    R = rotations(200, 0).astype(npd)
    # the four pivot branches: near-identity and the three half turns
    R[:4] = np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]), \
        np.diag([-1.0, -1.0, 1.0]), np.eye(3)
    ref = np.asarray(jse3.quat_from_matrix(jnp.asarray(R)))
    got = se3.quat_from_matrix(t(R))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.numpy(), ref, atol=atol)


@pytest.mark.parametrize("dt", DTYPES)
def test_triangulation_and_angle_error_match_jax(dt):
    npd, tdt, atol = DTYPES[dt]
    f0, f1, T = (x.astype(npd) for x in two_view(4, 32, 1))
    f1 = f1 + np.random.default_rng(2).normal(0, 1e-3, f1.shape).astype(npd)
    tri = jax.vmap(jgeometry.triangulate_midpoint)
    err = jax.vmap(jgeometry.reprojection_angle_error)
    args = tuple(jnp.asarray(x) for x in (f0, f1, T))
    targs = (t(f0), t(f1), t(T)[:, None])
    # the 2x2 normal equations are ill-conditioned at this parallax
    np.testing.assert_allclose(
        geometry.triangulate_midpoint(*targs).numpy(), np.asarray(tri(*args)),
        rtol=1e-2 if dt == "f32" else atol)
    got = geometry.reprojection_angle_error(*targs)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.numpy(), np.asarray(err(*args)), atol=atol)


@pytest.mark.parametrize("dt", DTYPES)
def test_decompose_essential_matches_jax(dt):
    npd, _, atol = DTYPES[dt]
    rng = np.random.default_rng(3)
    E = (np.asarray(jgeometry.skew(jnp.asarray(rng.normal(size=(50, 3)))))
         @ rotations(50, 4)).astype(npd)
    E[:10] += rng.normal(0, 1e-3, (10, 3, 3)).astype(npd)  # near-essential
    Rj, tj = jax.vmap(jgeometry.decompose_essential)(jnp.asarray(E))
    Rt, tt = geometry.decompose_essential(t(E))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=atol * 10)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=atol * 10)
    # the cofactor and the projection onto SO(3) on their own
    np.testing.assert_allclose(
        geometry._cofactor3(t(E)).numpy(),
        np.asarray(jax.vmap(jgeometry._cofactor3)(jnp.asarray(E))),
        atol=atol)
    np.testing.assert_allclose(
        geometry._orthonormalize_rows(t(E)).numpy(),
        np.asarray(jax.vmap(jgeometry._orthonormalize_rows)(jnp.asarray(E))),
        atol=atol * 10)


def test_eight_point_matches_jax():
    """The SVD's null vector has no fixed sign in either package, so each
    essential matrix is compared up to its sign."""
    f0, f1, _ = two_view(16, 8, 5)
    f1[8:] += np.random.default_rng(6).normal(0, 1e-3, f1[8:].shape)
    ref = np.asarray(jax.vmap(jgeometry.eight_point)(jnp.asarray(f0),
                                                     jnp.asarray(f1)))
    got = geometry.eight_point(t(f0), t(f1)).numpy()
    diff = np.minimum(np.abs(got - ref).max((1, 2)), np.abs(got + ref).max((1, 2)))
    assert diff.max() < 1e-10, diff.max()


def matched_share(ref, ref_valid, got, got_valid, tol, signed=False):
    """The share of the valid candidates ref (N, K, …) that have a valid
    candidate of got (N, K, …) of the same problem within ``tol``
    (max-abs; up to sign with ``signed``)."""
    r = ref.reshape(ref.shape[:2] + (-1,))[:, :, None]
    g = got.reshape(got.shape[:2] + (-1,))[:, None]
    d = np.abs(r - g).max(-1)
    if signed:
        d = np.minimum(d, np.abs(r + g).max(-1))
    d = np.where(got_valid[:, None, :], d, np.inf).min(-1)
    return float((d[ref_valid] <= tol).mean())


@functools.cache
def nister_reference(dt: str):
    """The JAX five-point solver's pieces on 64 samples of random two-view
    geometry: (f0, f1, Q, null basis, constraint matrix, Bxy, Bc, det,
    roots, root mask, candidates, candidate mask), as numpy."""
    npd = DTYPES[dt][0]
    f0, f1, _ = (x.astype(npd) for x in two_view(64, 5, 7))

    def pieces(a, b):
        Q = jnp.einsum("ni,nj->nij", a, b).reshape(5, 9)
        Eb = jnister._null4_of_5x9(Q)
        A = jnister._constraint_matrix(Eb.reshape(4, 3, 3))
        Bxy, Bc, det = jnister._action_polynomials(A)
        roots, valid = jnister.real_roots(det, 10)
        Es, ev = jnister.five_point_candidates(a, b)
        return Q, Eb, A, Bxy, Bc, det, roots, valid, Es, ev

    out = jax.jit(jax.vmap(pieces))(jnp.asarray(f0), jnp.asarray(f1))
    return (f0, f1) + tuple(np.asarray(x) for x in out)


def test_nister_pieces_match_jax():
    """Each piece of the five-point solver on the JAX package's own input
    to that piece, f64."""
    (f0, f1, Q, Eb, A, Bxy, Bc, det, roots, valid, Es,
     ev) = nister_reference("f64")
    np.testing.assert_allclose(nister._null4_of_5x9(t(Q)).numpy(), Eb,
                               atol=1e-12)
    np.testing.assert_allclose(
        nister._constraint_matrix(t(Eb).reshape(-1, 4, 3, 3)).numpy(), A,
        atol=1e-12)
    tBxy, tBc, tdet = nister._action_polynomials(t(A))
    scale = np.abs(det).max(-1, keepdims=True)
    np.testing.assert_allclose(tBxy.numpy(), Bxy, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(tBc.numpy(), Bc, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(tdet.numpy() / scale, det / scale, rtol=1e-7,
                               atol=1e-10)
    troots, tvalid = nister.real_roots(t(det), 10)
    np.testing.assert_array_equal(tvalid.numpy(), valid)
    np.testing.assert_allclose(troots.numpy()[valid], roots[valid],
                               rtol=1e-10, atol=1e-10)
    assert valid.sum() >= 64


@pytest.mark.parametrize("dt", DTYPES)
def test_five_point_candidates_match_jax(dt):
    f0, f1, *_, Es, ev = nister_reference(dt)
    tEs, tev = nister.five_point_candidates(t(f0), t(f1))
    assert tEs.shape == (64, 10, 3, 3) and tev.shape == (64, 10)
    assert tEs.dtype == DTYPES[dt][1]
    tEs, tev = tEs.numpy(), tev.numpy()
    if dt == "f64":
        np.testing.assert_array_equal(tev, ev)
        d = np.abs(tEs - Es).max((-2, -1))[ev]
        assert (d <= 1e-10).mean() >= 0.9 and d.max() <= 1e-5, d.max()
    else:
        *_, Es64, ev64 = nister_reference("f64")
        for tol in (1e-3, 1e-2):
            assert (matched_share(Es64, ev64, tEs, tev, tol, signed=True)
                    >= matched_share(Es64, ev64, Es, ev, tol, signed=True)
                    - 0.03)
        assert matched_share(Es, ev, tEs, tev, 1e-2, signed=True) >= 0.9


@pytest.mark.parametrize("dt", DTYPES)
def test_quartic_roots_match_jax(dt):
    npd, _, atol = DTYPES[dt]
    rng = np.random.default_rng(8)
    # random quartics, and ones with four real roots (monic products)
    c = rng.normal(size=(100, 5))
    r = rng.uniform(-3, 3, (100, 4))
    mon = np.stack([np.poly(x) for x in r])
    c = np.concatenate([c, mon]).astype(npd)
    rj, vj = jax.vmap(jp3p.quartic_real_roots)(jnp.asarray(c))
    rt, vt = p3p.quartic_real_roots(t(c))
    vj = np.asarray(vj)
    np.testing.assert_array_equal(vt.numpy(), vj)
    np.testing.assert_allclose(rt.numpy()[vj], np.asarray(rj)[vj],
                               atol=atol * 100, rtol=atol * 10)


@functools.cache
def p3p_problem(dt: str):
    """64 clean P3P samples in ``dt`` and the JAX package's candidates of
    them, (R, t) flattened to (64, 4, 12), with their mask."""
    npd = DTYPES[dt][0]
    rng = np.random.default_rng(9)
    Tcw = np.asarray(jse3.exp(jnp.asarray(rng.normal(0, 0.4, (64, 6)))))
    Pw = rng.normal(size=(64, 3, 3)) * 2.0
    Pc = np.array(jse3.act(jnp.asarray(Tcw)[:, None], jnp.asarray(Pw)))
    Pc[..., 2] += 8.0
    f = (Pc / np.linalg.norm(Pc, axis=-1, keepdims=True)).astype(npd)
    Pw = Pw.astype(npd)
    Rj, tj, vj = jax.vmap(jp3p.p3p_candidates)(jnp.asarray(f), jnp.asarray(Pw))
    return f, Pw, flat_poses(Rj, tj), np.asarray(vj)


def flat_poses(R, t):
    return np.concatenate([np.asarray(R).reshape(R.shape[:2] + (9,)),
                           np.asarray(t)], axis=-1)


@pytest.mark.parametrize("dt", DTYPES)
def test_p3p_candidates_match_jax(dt):
    f, Pw, ref, vj = p3p_problem(dt)
    Rt, tt, vt = p3p.p3p_candidates(t(f), t(Pw))
    got, vt = flat_poses(Rt.numpy(), tt.numpy()), vt.numpy()
    assert vj.any(axis=1).all()
    if dt == "f64":
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_allclose(got[vj], ref[vj], atol=1e-10)
    else:
        _, _, ref64, v64 = p3p_problem("f64")
        for tol in (1e-3, 1e-2):
            assert (matched_share(ref64, v64, got, vt, tol)
                    >= matched_share(ref64, v64, ref, vj, tol) - 0.03)
        assert matched_share(ref, vj, got, vt, 1e-2) >= 0.9


# ---------------------------------------------------------------------------
# the JAX tests' properties (tests/test_features.py), on the port alone
# ---------------------------------------------------------------------------


def test_five_point_recovers_true_essential():
    """Clean 5-point samples: the true E appears among the candidates."""
    rng = np.random.default_rng(0)
    f0s, f1s, Etrue = [], [], []
    for _ in range(4):
        xi = np.concatenate([rng.normal(0, 0.5, 3), rng.normal(0, 0.3, 3)])
        T = se3.exp(t(xi))
        p1 = t(rng.uniform(-1, 1, (5, 3)) + np.array([0, 0, 4.0]))
        p0 = se3.act(T, p1)
        f0s.append(p0 / torch.linalg.norm(p0, dim=-1, keepdim=True))
        f1s.append(p1 / torch.linalg.norm(p1, dim=-1, keepdim=True))
        E = geometry.essential_from_pose(T)
        Etrue.append(E / torch.linalg.norm(E))
    Es, valid = nister.five_point_candidates(torch.stack(f0s),
                                             torch.stack(f1s))
    for E, v, Et in zip(Es, valid, Etrue):
        assert v.sum() >= 1
        errs = [min(float(torch.linalg.norm(e - Et)),
                    float(torch.linalg.norm(e + Et)))
                for e, ok in zip(E, v) if ok]
        assert min(errs) < 1e-9, errs


def test_decompose_essential_matches_svd_form():
    """The closed-form decomposition reproduces the SVD decomposition's
    candidate set, (R, t) pairing included, to machine precision."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(11)
    R = np.stack([Rotation.random(random_state=1000 + i).as_matrix()
                  for i in range(100)])
    tv = rng.normal(size=(100, 3))
    tv /= np.linalg.norm(tv, axis=1, keepdims=True)
    E = (geometry.skew(t(tv)) @ t(R)) * t(rng.uniform(0.2, 5.0, (100, 1, 1)))
    Rs, ts = geometry.decompose_essential(E)
    err = ((Rs - t(R)[:, None]).abs().amax((-2, -1))
           + (ts - t(tv)[:, None]).abs().amax(-1)).amin(-1)
    assert float(err.max()) < 1e-12, float(err.max())


def test_p3p_triad_alignment_exact():
    """The SVD-free alignment recovers the exact pose of clean
    correspondences among the four candidates."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(12)
    fs, Pws, Rs_true, ts_true = [], [], [], []
    for i in range(50):
        R = Rotation.random(random_state=2000 + i).as_matrix()
        tv = rng.normal(size=3)
        Pw = rng.normal(size=(3, 3)) * 2.0
        Pc = (R @ Pw.T).T + tv + np.array([0, 0, 8.0])
        if (Pc[:, 2] <= 0.1).any():
            continue
        fs.append(Pc / np.linalg.norm(Pc, axis=1, keepdims=True))
        Pws.append(Pw)
        Rs_true.append(R)
        ts_true.append(tv + np.array([0, 0, 8.0]))
    Rs, ts, valid = p3p.p3p_candidates(t(np.stack(fs)), t(np.stack(Pws)))
    err = ((Rs - t(np.stack(Rs_true))[:, None]).abs().amax((-2, -1))
           + (ts - t(np.stack(ts_true))[:, None]).abs().amax(-1))
    err = torch.where(valid, err, torch.inf).amin(-1)
    assert len(fs) >= 40 and float(err.max()) < 1e-6, float(err.max())


def test_triangulate_midpoint_exact():
    f0, f1, T = two_view(3, 40, 13)
    p0 = geometry.triangulate_midpoint(t(f0), t(f1), t(T)[:, None])
    n0 = p0 / torch.linalg.norm(p0, dim=-1, keepdim=True)
    np.testing.assert_allclose(n0.numpy(), f0, atol=1e-9)
