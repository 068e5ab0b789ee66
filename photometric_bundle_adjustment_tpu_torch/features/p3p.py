"""Grunert's P3P minimal absolute-pose solver, batched over a leading
hypothesis axis.

Port of ``photometric_bundle_adjustment_tpu/features/p3p.py``, the
minimal solver that replaces the reference's EPnP inside a sequential
RANSAC (include/visnav/map_utils.h:268-278): with s_i the camera-frame
distances of the three world points, s2 = u s1 and s3 = v s1 in the three
law-of-cosines equations leave a quartic in v.  Its coefficients come from
products of small polynomials, its real roots from Ferrari's closed form
(the resolvent cubic by Cardano, branches chosen by ``torch.where``, one
Newton polish), and each root gives camera-frame points whose rigid
alignment to the world points (the two triangles' frames, no SVD) is
T_c_w.  Derivation: Haralick et al., "Review and Analysis of Solutions of
the Three Point Perspective Pose Estimation Problem".

The ``1e-300`` guards underflow to 0 in f32, as they do in the JAX
package's f32 path: the literals are kept so that both fail alike.
"""

from __future__ import annotations

import torch

from photometric_bundle_adjustment_tpu_torch.features.nister import poly_mul


def _cube(x):
    """x^3 as ``lax.integer_pow`` computes it: x (x x)."""
    return x * (x * x)


def _cbrt(x):
    """Real cube root, negative arguments included: sign(x) |x|^(1/3)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _cubic_one_real_root(b, c, d):
    """One real root of x^3 + b x^2 + c x + d: Cardano where one root is
    real, else the trigonometric form's largest root."""
    p = c - b * b / 3.0
    q = 2.0 * _cube(b) / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) * (q / 2.0) + _cube(p / 3.0)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    root_card = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)
    # three real roots (casus irreducibilis): 2 sqrt(-p/3) cos(phi/3)
    pm = torch.sqrt(torch.clamp(-p / 3.0, min=1e-300))
    cosphi = torch.clamp(3.0 * q / (2.0 * p * pm + 1e-300), -1.0, 1.0)
    root_trig = 2.0 * pm * torch.cos(torch.arccos(cosphi) / 3.0)
    return torch.where(disc > 0.0, root_card, root_trig) - b / 3.0


def quartic_real_roots(coeffs: torch.Tensor):
    """Real roots of quartics with descending coefficients (…, 5) by
    Ferrari's closed form, then one Newton step.  Returns (roots (…, 4),
    valid (…, 4))."""
    dtype = coeffs.dtype
    a0c = coeffs[..., 0:1]
    a = coeffs / (a0c + torch.where(a0c == 0.0, torch.finfo(dtype).tiny, 0.0))
    a3, a2, a1, a0 = a[..., 1], a[..., 2], a[..., 3], a[..., 4]
    # depressed quartic y^4 + p y^2 + q y + r with x = y - a3/4
    a3sq = a3 * a3
    p = a2 - 3.0 * a3 * a3 / 8.0
    q = a1 - a3 * a2 / 2.0 + _cube(a3) / 8.0
    r = a0 - a3 * a1 / 4.0 + a3sq * a2 / 16.0 - 3.0 * (a3sq * a3sq) / 256.0
    # resolvent cubic 8m^3 + 8p m^2 + (2p^2 - 8r) m - q^2 = 0 (monic form)
    m = _cubic_one_real_root(p, (2.0 * p * p - 8.0 * r) / 8.0, -q * q / 8.0)
    m = torch.clamp(m, min=0.0)
    s = torch.sqrt(torch.clamp(2.0 * m, min=0.0))
    safe = s > 1e-14
    q_over = torch.where(safe, q / torch.where(safe, 2.0 * s, 1.0), 0.0)
    # y^2 - s y + (p/2 + m + q/(2s)) = 0 and y^2 + s y + (p/2 + m - ...)
    c1 = p / 2.0 + m + q_over
    c2 = p / 2.0 + m - q_over
    # the biquadratic when q ~ 0 and m ~ 0: y^2 = (-p +- sqrt(p^2-4r))/2
    dbi = p * p - 4.0 * r
    y2a = (-p + torch.sqrt(torch.clamp(dbi, min=0.0))) / 2.0
    y2b = (-p - torch.sqrt(torch.clamp(dbi, min=0.0))) / 2.0

    def quad(b_, c_):
        d_ = b_ * b_ - 4.0 * c_
        sd = torch.sqrt(torch.clamp(d_, min=0.0))
        ok = d_ >= 0.0
        return ((-b_ + sd) / 2.0, ok), ((-b_ - sd) / 2.0, ok)

    (ra, va), (rb, vb) = quad(-s, c1)
    (rc, vc), (rd, vd) = quad(s, c2)
    roots_f = torch.stack([ra, rb, rc, rd], dim=-1)
    valid_f = torch.stack([va, vb, vc, vd], dim=-1)
    ya = torch.sqrt(torch.clamp(y2a, min=0.0))
    yb = torch.sqrt(torch.clamp(y2b, min=0.0))
    roots_b = torch.stack([ya, -ya, yb, -yb], dim=-1)
    oka = (dbi >= 0.0) & (y2a >= 0.0)
    okb = (dbi >= 0.0) & (y2b >= 0.0)
    valid_b = torch.stack([oka, oka, okb, okb], dim=-1)
    use_bi = ((~safe) & (torch.abs(q) < 1e-12))[..., None]
    roots = torch.where(use_bi, roots_b, roots_f) - a3[..., None] / 4.0
    valid = torch.where(use_bi, valid_b, valid_f)
    # one Newton polish step
    e = torch.arange(4, -1, -1, dtype=dtype, device=coeffs.device)
    powers = roots[..., None] ** e
    dpow = e[:-1] * roots[..., None] ** e[1:]
    f_val = torch.sum(powers * a[..., None, :], dim=-1)
    f_der = torch.sum(dpow * a[..., None, :4], dim=-1)
    roots = roots - f_val / torch.where(torch.abs(f_der) > 1e-30, f_der, 1e30)
    return roots, valid


def _triad(P: torch.Tensor, tiny: float):
    """The right-handed orthonormal frames (columns) of point triples P
    (…, 3, 3): x along P1 - P0, z along the triangle's normal.  Returns
    (B (…, 3, 3), ok): ok False where the points are (nearly) collinear."""
    d1 = P[..., 1, :] - P[..., 0, :]
    d2 = P[..., 2, :] - P[..., 0, :]
    n1 = torch.linalg.norm(d1, dim=-1, keepdim=True)
    x = d1 / torch.clamp(n1, min=tiny)
    zraw = torch.linalg.cross(d1, d2, dim=-1)
    nz = torch.linalg.norm(zraw, dim=-1, keepdim=True)
    z = zraw / torch.clamp(nz, min=tiny)
    y = torch.linalg.cross(z, x, dim=-1)
    ok = (nz > 1e-9 * n1 * torch.linalg.norm(d2, dim=-1, keepdim=True))[..., 0]
    return torch.stack([x, y, z], dim=-1), ok


def _rigid_3pt(Pw: torch.Tensor, Pc: torch.Tensor, tiny: float):
    """Rigid T_c_w aligning world points Pw (…, 3, 3) onto camera points
    Pc (…, 3, 3): (R, t, ok) with Pc ~= R Pw + t, the rotation between the
    two congruent triangles' frames."""
    Bw, okw = _triad(Pw, tiny)
    Bc, okc = _triad(Pc, tiny)
    R = torch.sum(Bc[..., :, None, :] * Bw[..., None, :, :], dim=-1)
    cw = Pw.mean(dim=-2)
    cc = Pc.mean(dim=-2)
    t = cc - torch.sum(R * cw[..., None, :], dim=-1)
    return R, t, okw & okc


def p3p_candidates(f: torch.Tensor, Pw: torch.Tensor):
    """Absolute-pose candidates from 3 bearing-point correspondences per
    hypothesis.

    f (…, 3, 3): unit bearings in the camera frame; Pw (…, 3, 3): world
    points.  Returns Rs (…, 4, 3, 3) and ts (…, 4, 3), candidate T_c_w
    (x_cam = R x_w + t), and valid (…, 4): real roots with the points in
    front of the camera and a non-degenerate triangle."""
    dtype = f.dtype
    tiny = torch.finfo(dtype).tiny

    def dot(u, v):
        return torch.sum(u * v, dim=-1)

    ca = dot(f[..., 1, :], f[..., 2, :])   # cos(alpha), opposite |P2P3|
    cb = dot(f[..., 0, :], f[..., 2, :])   # cos(beta), opposite |P1P3|
    cg = dot(f[..., 0, :], f[..., 1, :])   # cos(gamma), opposite |P1P2|

    def sq(u):
        return torch.sum(u * u, dim=-1)

    a2 = sq(Pw[..., 1, :] - Pw[..., 2, :])
    b2 = torch.clamp(sq(Pw[..., 0, :] - Pw[..., 2, :]), min=tiny)
    c2 = sq(Pw[..., 0, :] - Pw[..., 1, :])
    m = (a2 - c2) / b2
    n = c2 / b2

    # u = P(v) / Q(v) with P(v) = (m-1) v^2 - 2 m cb v + (m+1),
    # Q(v) = 2 (cg - v ca), substituted into
    # u^2 - 2 u cg + 1 - n (1 + v^2 - 2 v cb) = 0 and multiplied by Q^2:
    # P^2 - 2 cg P Q + W Q^2 = 0, W(v) = -n v^2 + 2 n cb v + (1 - n)
    P = torch.stack([m - 1.0, -2.0 * m * cb, m + 1.0], dim=-1)
    Q = torch.stack([-2.0 * ca, 2.0 * cg], dim=-1)
    W = torch.stack([-n, 2.0 * n * cb, 1.0 - n], dim=-1)
    PQ = torch.cat([torch.zeros_like(P[..., :1]), poly_mul(P, Q)], dim=-1)
    quart = (poly_mul(P, P) - 2.0 * cg[..., None] * PQ
             + poly_mul(W, poly_mul(Q, Q)))                # (…, 5)

    v, vvalid = quartic_real_roots(quart)                   # (…, 4)
    m_, cb_, ca_, cg_, b2_ = (x[..., None] for x in (m, cb, ca, cg, b2))
    den = 2.0 * (cg_ - v * ca_)
    u = (((m_ - 1.0) * v - 2.0 * m_ * cb_) * v + (m_ + 1.0)) / (
        den + torch.where(cg_ == v * ca_, tiny, 0.0))
    s1sq = b2_ / torch.clamp(1.0 + v * v - 2.0 * v * cb_, min=tiny)
    s1 = torch.sqrt(torch.clamp(s1sq, min=0.0))
    s = torch.stack([s1, u * s1, v * s1], dim=-1)           # (…, 4, 3)
    Pc = s[..., None] * f[..., None, :, :]                  # camera points
    R, t, ok_geom = _rigid_3pt(Pw[..., None, :, :], Pc, tiny)
    ok = (s > 0.0).all(dim=-1) & ok_geom                    # in front
    finite = (torch.isfinite(R).all(dim=-1).all(dim=-1)
              & torch.isfinite(t).all(dim=-1))
    return R, t, vvalid & ok & finite
