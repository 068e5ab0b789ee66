"""Nister's five-point minimal essential-matrix solver, batched over a
leading hypothesis axis.

Port of ``photometric_bundle_adjustment_tpu/features/nister.py``, the
batched replacement of the reference's OpenGV ``NISTER`` RANSAC sampler
(include/visnav/matching_utils.h:111-124).  Every step is a fixed-shape
tensor operation over all hypotheses at once, and the polynomial roots
need no eigenvalue solver:

1. the nullspace of the 5x9 epipolar constraint matrix, by the same 5
   Householder reflectors as the JAX package (so the basis, and with it
   the order of the candidates, is the same): E = x E1 + y E2 + z E3 + E4;
2. the 10 cubic constraints (det E = 0 and 2 E E^T E - tr(E E^T) E = 0)
   over fixed monomial bases, through two constant product tensors;
3. a pivot-free Gauss-Jordan inverse of the leading 10x10 block with two
   refinement steps, then Nister's three compatibility rows: a 3x3 matrix
   B(z) of polynomials whose determinant has degree 10;
4. its real roots on the projective angle z = tan(theta): sign changes
   over a fixed 254-point theta grid, evaluated homogeneously (one f64 or
   f32 product against a constant power table), refined by 14 bisections
   and 3 safeguarded Newton steps, in up to 10 root slots with a mask;
5. x, y of each root from the 3x2 least-squares system B(z) [x y 1]^T = 0.

The loops are Python loops of fixed length over batched tensors; nothing
syncs the host.  f64 is recommended (the reduced system is
ill-conditioned in f32), but the module keeps the dtype it is given.
Products of this module must not run in TF32: callers hold
``optim.ba.full_f32`` around it on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# monomial bases and constant product tensors
# ---------------------------------------------------------------------------

_LIN = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]  # [x, y, z, 1]
_QUAD = [
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (1, 0, 0),
    (0, 2, 0), (0, 1, 1), (0, 1, 0),
    (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
# cubic basis in the Gauss-Jordan order: leading block L then trailing v
# L = [x^3, y^3, x^2 y, x y^2, x^2 z, x^2, y^2 z, y^2, x y z, x y]
# v = [x z^2, x z, x, y z^2, y z, y, z^3, z^2, z, 1]
_CUBIC = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_QIDX = {m: i for i, m in enumerate(_QUAD)}
_CIDX = {m: i for i, m in enumerate(_CUBIC)}


def _product_tensors():
    M_llq = np.zeros((4, 4, 10))
    for i, a in enumerate(_LIN):
        for j, b in enumerate(_LIN):
            m = tuple(x + y for x, y in zip(a, b))
            M_llq[i, j, _QIDX[m]] = 1.0
    M_qlc = np.zeros((10, 4, 20))
    for i, a in enumerate(_QUAD):
        for j, b in enumerate(_LIN):
            m = tuple(x + y for x, y in zip(a, b))
            M_qlc[i, j, _CIDX[m]] = 1.0
    return M_llq, M_qlc


_M_LLQ, _M_QLC = _product_tensors()

# the root grid: theta over (-pi/2, pi/2) without its ends, and the
# homogeneous power table P[i, g] = sin(theta_g)^(D-i) cos(theta_g)^i of
# each degree, built once per (degree, grid size)
_GRID = 256
_TABLES: dict = {}


def _grid(D: int, n_grid: int):
    if (D, n_grid) not in _TABLES:
        th = np.linspace(-np.pi / 2, np.pi / 2, n_grid)[1:-1]
        P = np.stack([np.sin(th) ** (D - i) * np.cos(th) ** i
                      for i in range(D + 1)], axis=0)
        _TABLES[D, n_grid] = (th, P)
    return _TABLES[D, n_grid]


def _const(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _ll(a, b, M_llq):
    """linear (…, 4) x linear (…, 4) -> quadratic (…, 10)."""
    return torch.einsum("...i,...j,ijk->...k", a, b, M_llq)


def _ql(q, l, M_qlc):
    """quadratic (…, 10) x linear (…, 4) -> cubic (…, 20)."""
    return torch.einsum("...i,...j,ijk->...k", q, l, M_qlc)


# ---------------------------------------------------------------------------
# constraint matrix
# ---------------------------------------------------------------------------


def _constraint_matrix(Ebasis: torch.Tensor) -> torch.Tensor:
    """Ebasis (N, 4, 3, 3), the nullspace bases [E1, E2, E3, E4].  Returns
    the (N, 10, 20) coefficients of the 10 cubic constraints over the
    ``_CUBIC`` monomials."""
    M_llq, M_qlc = _const(_M_LLQ, Ebasis), _const(_M_QLC, Ebasis)
    # E entry (i, j) as a linear polynomial over [x, y, z, 1]
    Elin = Ebasis.permute(0, 2, 3, 1)                     # (N, 3, 3, 4)
    # P = E E^T (quadratic), P_ij = sum_k E_ik E_jk
    P = torch.einsum("nika,njkb,abq->nijq", Elin, Elin, M_llq)
    trace = P[:, 0, 0] + P[:, 1, 1] + P[:, 2, 2]          # (N, 10)
    # C = P E (cubic): C_il = sum_j P_ij E_jl
    C = torch.einsum("nijq,njla,qac->nilc", P, Elin, M_qlc)
    trE = _ql(trace[:, None, None, :].expand(-1, 3, 3, -1), Elin, M_qlc)
    trace_rows = (2.0 * C - trE).reshape(-1, 9, 20)

    # det(E) cubic: expansion along the first row
    def minor(r0, r1, c0, c1):
        return (_ll(Elin[:, r0, c0], Elin[:, r1, c1], M_llq)
                - _ll(Elin[:, r0, c1], Elin[:, r1, c0], M_llq))

    det = (_ql(minor(1, 2, 1, 2), Elin[:, 0, 0], M_qlc)
           - _ql(minor(1, 2, 0, 2), Elin[:, 0, 1], M_qlc)
           + _ql(minor(1, 2, 0, 1), Elin[:, 0, 2], M_qlc))
    return torch.cat([det[:, None, :], trace_rows], dim=1)


# ---------------------------------------------------------------------------
# degree-10 polynomial and roots
# ---------------------------------------------------------------------------


def poly_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Products of polynomial coefficient vectors (…, la) x (…, lb) ->
    (…, la + lb - 1), descending or ascending alike: the sum of a[i] b
    shifted by i, added in the order of i."""
    la = a.shape[-1]
    out = 0.0
    for i in range(la):
        out = out + F.pad(a[..., i:i + 1] * b, (i, la - 1 - i))
    return out


def _gauss_jordan_inv(A: torch.Tensor) -> torch.Tensor:
    """Inverses of (N, n, n) matrices by pivot-free Gauss-Jordan
    elimination over the n static steps; a pivot smaller than the dtype's
    tiny is clamped to +-tiny.  The refinement steps of the caller recover
    the accuracy that the missing pivot search costs (JAX nister.py
    documents the trade)."""
    n = A.shape[-1]
    tiny = torch.finfo(A.dtype).tiny
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    aug = torch.cat([A, eye], dim=-1)                      # (N, n, 2n)
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        piv = aug[:, k, k]
        clamp = torch.full_like(piv, tiny)
        piv = torch.where(torch.abs(piv) > tiny, piv,
                          torch.where(piv < 0, -clamp, clamp))
        piv_row = aug[:, k] / piv[:, None]
        factors = torch.where(rows == k, 0.0, aug[:, :, k])
        aug = aug - factors[:, :, None] * piv_row[:, None, :]
        aug = torch.where((rows == k)[None, :, None], piv_row[:, None, :], aug)
    return aug[:, :, n:]


def _action_polynomials(A: torch.Tensor):
    """A (N, 10, 20), the constraint matrices.  Returns B(z) as
    (Bxy (N, 3, 2, 4), Bc (N, 3, 5)), coefficients in descending powers,
    and the degree-10 determinants (N, 11), descending."""
    A1, A2 = A[:, :, :10], A[:, :, 10:]
    A1inv = _gauss_jordan_inv(A1)
    X = A1inv @ A2
    # two refinement steps against the pivot-free elimination's rounding
    X = X + A1inv @ (A2 - A1 @ X)
    X = X + A1inv @ (A2 - A1 @ X)

    # leading-monomial indices in L: x^2=5, x^2 z=4; y^2=7, y^2 z=6;
    # x y=9, x y z=8.  Row for pair (m, mz): z*expr(m) - expr(mz) = 0.
    def row(m, mz):
        c, d = -X[:, m], -X[:, mz]
        bx = torch.stack([c[:, 0], c[:, 1] - d[:, 0], c[:, 2] - d[:, 1],
                          -d[:, 2]], dim=-1)
        by = torch.stack([c[:, 3], c[:, 4] - d[:, 3], c[:, 5] - d[:, 4],
                          -d[:, 5]], dim=-1)
        bc = torch.stack([c[:, 6], c[:, 7] - d[:, 6], c[:, 8] - d[:, 7],
                          c[:, 9] - d[:, 8], -d[:, 9]], dim=-1)
        return bx, by, bc

    rows = [row(5, 4), row(7, 6), row(9, 8)]
    Bx = torch.stack([r[0] for r in rows], dim=1)          # (N, 3, 4)
    By = torch.stack([r[1] for r in rows], dim=1)          # (N, 3, 4)
    Bc = torch.stack([r[2] for r in rows], dim=1)          # (N, 3, 5)

    # det expansion along the x-column
    def minor(r1, r2):
        return (poly_mul(By[:, r1], Bc[:, r2])
                - poly_mul(By[:, r2], Bc[:, r1]))          # (N, 8)

    det = (poly_mul(Bx[:, 0], minor(1, 2))
           - poly_mul(Bx[:, 1], minor(0, 2))
           + poly_mul(Bx[:, 2], minor(0, 1)))              # (N, 11)
    return torch.stack([Bx, By], dim=2), Bc, det


def _powers(x: torch.Tensor, D: int) -> torch.Tensor:
    """(…, D+1) with x^0 .. x^D along the last axis, by repeated
    multiplication."""
    ps = [torch.ones_like(x)]
    for _ in range(D):
        ps.append(ps[-1] * x)
    return torch.stack(ps, dim=-1)


def _eval_homog(coeffs, s, c):
    """sum_i coeffs[i] s^(D-i) c^i: the polynomial with descending
    ``coeffs`` (…, D+1) at z = s/c, times c^D (the same sign for c > 0).
    s, c (…) broadcast against coeffs' leading axes."""
    D = coeffs.shape[-1] - 1
    ps = [torch.ones_like(s)]
    for _ in range(D):
        ps.append(ps[-1] * s)
    sp = torch.stack(ps[::-1], dim=-1)                    # s^D .. s^0
    return torch.sum(coeffs * sp * _powers(c, D), dim=-1)


def _eval_homog_deriv(coeffs, s, c):
    """d/dtheta of ``_eval_homog`` at (s, c) = (sin, cos) theta:
    d/dtheta [s^(D-i) c^i] = (D-i) s^(D-i-1) c^(i+1) - i s^(D-i+1) c^(i-1)."""
    D = coeffs.shape[-1] - 1
    ps = [torch.ones_like(s)]
    for _ in range(D + 1):
        ps.append(ps[-1] * s)
    cs = [torch.ones_like(c)]
    for _ in range(D + 1):
        cs.append(cs[-1] * c)
    terms = []
    for i in range(D + 1):
        t1 = (D - i) * ps[D - i - 1] * cs[i + 1] if i < D else 0.0
        t2 = i * ps[D - i + 1] * cs[i - 1] if i > 0 else 0.0
        terms.append(t1 - t2)
    return torch.sum(coeffs * torch.stack(terms, dim=-1), dim=-1)


def real_roots(coeffs: torch.Tensor, max_roots: int, n_grid: int = _GRID,
               n_bisect: int = 14, n_newton: int = 3):
    """Up to ``max_roots`` real roots of polynomials with descending
    coefficients (N, D+1).  Returns (roots (N, max_roots), valid (N,
    max_roots)).

    The projective grid z = tan(theta) over n_grid - 2 interior points;
    each sign change brackets a root, the first ``max_roots`` changes in
    grid order fill the slots (a stable descending sort of the JAX
    package's scores, so the slots of ``lax.top_k`` and their order),
    then 14 bisections and 3 Newton steps in theta kept inside the
    bracket.  Tight root pairs inside one grid cell cancel their sign
    change and are lost, as in the JAX package."""
    dtype = coeffs.dtype
    tiny = torch.finfo(dtype).tiny
    D = coeffs.shape[-1] - 1
    scale = torch.amax(torch.abs(coeffs), dim=-1, keepdim=True)
    det = coeffs / torch.clamp(scale, min=tiny)

    th_np, P_np = _grid(D, n_grid)
    theta = _const(th_np, det)
    # the grid as one product against the constant power table
    q = det @ _const(P_np, det)                            # (N, G)
    change = (q[:, :-1] * q[:, 1:]) < 0.0
    n = change.shape[-1]
    score = change.to(dtype) * (2.0 * n - torch.arange(n, dtype=dtype,
                                                       device=det.device))
    top, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top, idx = top[:, :max_roots], idx[:, :max_roots]
    valid = top > 0.0
    lo, hi = theta[idx], theta[idx + 1]
    qlo = torch.gather(q, 1, idx)
    coef = det[:, None, :]
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        qm = _eval_homog(coef, torch.sin(mid), torch.cos(mid))
        left = (qlo * qm) > 0.0
        lo, hi, qlo = (torch.where(left, mid, lo), torch.where(left, hi, mid),
                       torch.where(left, qm, qlo))
    th = 0.5 * (lo + hi)
    big = torch.finfo(dtype).max
    for _ in range(n_newton):
        s, c = torch.sin(th), torch.cos(th)
        f = _eval_homog(coef, s, c)
        fp = _eval_homog_deriv(coef, s, c)
        step = f / torch.where(torch.abs(fp) > tiny, fp, big)
        # keep the iterate inside the bisection bracket (safeguarded)
        th = torch.minimum(torch.maximum(th - step, lo), hi)
    return torch.tan(th), valid


# ---------------------------------------------------------------------------
# public solver
# ---------------------------------------------------------------------------


def _null4_of_5x9(Q: torch.Tensor) -> torch.Tensor:
    """Orthonormal bases (N, 4, 9) of null(Q) for full-rank Q (N, 5, 9), by
    5 Householder reflectors on Q^T: with Q^T = H1 .. H5 [R; 0], the
    reflectors applied to e_5 .. e_8 are orthonormal and annihilated by Q.
    The same reflectors as the JAX package, so the same basis."""
    dtype = Q.dtype
    tiny = torch.finfo(dtype).tiny
    A = Q.transpose(-1, -2)                                # (N, 9, 5)
    n = A.shape[-2]
    rows = torch.arange(n, device=Q.device)
    vs = []
    for k in range(5):
        x = torch.where(rows >= k, A[:, :, k], 0.0)
        nx = torch.linalg.norm(x, dim=-1)
        # alpha = -sign(x_k) ||x|| avoids cancellation
        alpha = -torch.where(x[:, k] >= 0, nx, -nx)
        v = x - alpha[:, None] * (rows == k).to(dtype)
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                            min=tiny)
        A = A - 2.0 * v[:, :, None] * torch.einsum("ni,nij->nj", v, A)[:, None]
        vs.append(v)
    N = torch.zeros((Q.shape[0], n, 4), dtype=dtype, device=Q.device)
    N[:, 5:, :] = torch.eye(4, dtype=dtype, device=Q.device)
    for v in reversed(vs):                                 # H1 .. H5 [e5..e8]
        N = N - 2.0 * v[:, :, None] * torch.einsum("ni,nij->nj", v, N)[:, None]
    return N.transpose(-1, -2)


def five_point_candidates(f0: torch.Tensor, f1: torch.Tensor):
    """Essential-matrix candidates from 5 bearing correspondences per
    hypothesis.

    f0, f1 (…, 5, 3): unit bearings with f0^T E f1 = 0.  Returns
    Es (…, 10, 3, 3), the candidates (Frobenius-normalised; zero where
    not finite), and valid (…, 10), the real-root slots found."""
    lead = f0.shape[:-2]
    dtype = f0.dtype
    tiny = torch.finfo(dtype).tiny
    f0, f1 = f0.reshape(-1, 5, 3), f1.reshape(-1, 5, 3)
    Q = (f0[..., :, None] * f1[..., None, :]).reshape(-1, 5, 9)
    Ebasis = _null4_of_5x9(Q).reshape(-1, 4, 3, 3)         # [E1, E2, E3, E4]

    A = _constraint_matrix(Ebasis)
    Bxy, Bc, det = _action_polynomials(A)
    z, valid = real_roots(det, 10)                         # (N, 10)

    s = z / torch.sqrt(1.0 + z * z)
    c = 1.0 / torch.sqrt(1.0 + z * z)
    # rows scaled by c^4: [c Bx_h, c By_h, Bc_h]
    gxy = _eval_homog(Bxy[:, None], s[..., None, None], c[..., None, None])
    gc = _eval_homog(Bc[:, None], s[..., None], c[..., None])  # (N, 10, 3)
    G = gxy * c[..., None, None]                           # (N, 10, 3, 2)
    # least squares for [x, y]: the closed-form 2x2 normal equations
    H = (torch.sum(G[..., :, :, None] * G[..., :, None, :], dim=-3)
         + tiny * torch.eye(2, dtype=dtype, device=f0.device))
    b = -torch.sum(G * gc[..., None], dim=-2)              # (N, 10, 2)
    det_h = H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0]
    inv_det = 1.0 / torch.where(det_h != 0.0, det_h,
                                torch.full_like(det_h, tiny))
    x = (H[..., 1, 1] * b[..., 0] - H[..., 0, 1] * b[..., 1]) * inv_det
    y = (H[..., 0, 0] * b[..., 1] - H[..., 1, 0] * b[..., 0]) * inv_det
    Eb = Ebasis[:, None]
    E = (x[..., None, None] * Eb[:, :, 0] + y[..., None, None] * Eb[:, :, 1]
         + z[..., None, None] * Eb[:, :, 2] + Eb[:, :, 3])
    nrm = torch.linalg.norm(E.reshape(E.shape[:-2] + (9,)), dim=-1)
    Es = E / torch.clamp(nrm, min=tiny)[..., None, None]
    finite = torch.all(torch.isfinite(Es.reshape(Es.shape[:-2] + (9,))),
                       dim=-1)
    Es = torch.where(finite[..., None, None], Es, 0.0)
    return (Es.reshape(lead + (10, 3, 3)),
            (valid & finite).reshape(lead + (10,)))
