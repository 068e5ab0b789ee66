"""Parity of the port's generic manifold LM (optim/lm.py), its entry step
(entry.py) and the non-fused photometric solver
(models/photometric_ba.make_solver) with the JAX package's.

``lm_solve`` is held to the reference's SE3-manifold acceptance test
(tests/test_se3.py:98-127, test_ceres_se3.cpp:93-127: the 9 target/init
pairs, ||log(T_targ^-1 T)||^2 < 10 eps) and, on a robust point-alignment
fit with outliers and a fixed direction, to the JAX ``lm_solve`` (same
iterations, final pose atol 1e-10, cost rtol 1e-10 in f64).  ``entry()``
is held to ``__graft_entry__.entry()`` in f32 (cost rtol 2e-4, deltas
atol 2e-3 x max|ref|), ``make_solver`` to the JAX one (final cost rtol
2e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from photometric_bundle_adjustment_tpu.core import se3 as jse3
from photometric_bundle_adjustment_tpu.models import photometric_ba as jpba
from photometric_bundle_adjustment_tpu.models import synthetic as jsyn
from photometric_bundle_adjustment_tpu.optim import ba as jba
from photometric_bundle_adjustment_tpu.optim import lm as jlm
from photometric_bundle_adjustment_tpu_torch import entry as tentry
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.core import se3 as tse3
from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as tpba
from photometric_bundle_adjustment_tpu_torch.optim import ba as tba
from photometric_bundle_adjustment_tpu_torch.optim import lm as tlm

torch.set_num_threads(1)

EPS = float(np.finfo(np.float64).eps)
PI = float(np.pi)


def _se3_cases():
    """The 9 poses of test_ceres_se3.cpp:99-119 (tests/test_se3.py), as
    numpy (7,) rows built with the JAX package's se3."""
    def make(rv, t):
        return jse3.make(jnp.asarray(t, jnp.float64),
                         jse3.so3_exp(jnp.asarray(rv, jnp.float64)))

    c = [make([0.2, 0.5, 0.0], [0, 0, 0]), make([0.2, 0.5, -1.0], [10, 0, 0]),
         make([0.0, 0.0, 0.0], [0, 100, 5]),
         make([0.0, 0.0, 0.00001], [0, 0, 0]),
         make([0.0, 0.0, 0.00001], [0, -0.00000001, 0.0000000001]),
         make([0.0, 0.0, 0.00001], [0.01, 0, 0]),
         make([PI, 0, 0], [4, -5, 0]),
         jse3.compose(jse3.compose(make([0.2, 0.5, 0.0], [0, 0, 0]),
                                   make([PI, 0, 0], [0, 0, 0])),
                      make([-0.2, -0.5, -0.0], [0, 0, 0])),
         jse3.compose(jse3.compose(make([0.3, 0.5, 0.1], [2, 0, -7]),
                                   make([PI, 0, 0], [0, 0, 0])),
                      make([-0.3, -0.5, -0.1], [0, 6, 0]))]
    return [np.array(x) for x in c]


@pytest.mark.parametrize("i", range(9))
def test_lm_solve_se3_manifold_optimization(i):
    """The reference's acceptance test on the port: minimise
    ||log(T_targ^-1 T)||^2 from the case 3 further on."""
    cases = _se3_cases()
    T_targ = torch.as_tensor(cases[i])
    T_init = torch.as_tensor(cases[(i + 3) % len(cases)])
    T_aw = tse3.inverse(T_targ)
    cfg = tlm.LMConfig(max_iterations=50, function_tolerance=0.01 * EPS,
                       gradient_tolerance=0.0, parameter_tolerance=0.0)
    T_fin, res = tlm.lm_solve(lambda T: tse3.log(tse3.compose(T_aw, T)),
                              T_init, tse3.right_plus, 6, cfg)
    mse = float(torch.sum(tse3.log(tse3.compose(T_aw, T_fin)) ** 2))
    assert mse < 10.0 * EPS, f"case {i}: mse={mse}"
    assert float(res.cost) <= float(res.initial_cost)


def _alignment_problem():
    """24 points seen through a pose, 4 of them gross outliers: the fit
    of T with Huber on 3-blocks from a start that differs from the truth
    only in the free directions (the first tangent direction is held
    fixed)."""
    rng = np.random.default_rng(11)
    P = rng.normal(0, 2, (24, 3))
    T_true = np.asarray(jse3.exp(jnp.asarray([0.3, -0.2, 0.1, 0.2, -0.4, 0.3])))
    Q = np.asarray(jse3.act(jnp.asarray(T_true), jnp.asarray(P)))
    Q = Q + rng.normal(0, 0.01, Q.shape)
    Q[:4] += rng.normal(0, 3.0, (4, 3))
    T0 = np.asarray(jse3.right_plus(
        jnp.asarray(T_true), jnp.asarray([0.0, 0.1, -0.1, 0.05, 0.0, 0.1])))
    fixed = np.array([True, False, False, False, False, False])
    return P, Q, T0, fixed, T_true


def test_lm_solve_matches_jax_with_huber_and_fixed_direction():
    P, Q, T0, fixed, T_true = _alignment_problem()
    kw = dict(max_iterations=30, huber_delta=0.05, block_size=3)

    Pj, Qj = jnp.asarray(P), jnp.asarray(Q)
    T_j, res_j = jlm.lm_solve(
        lambda T: (jse3.act(T, Pj) - Qj).reshape(-1), jnp.asarray(T0),
        jse3.right_plus, 6, jlm.LMConfig(**kw), fixed_mask=jnp.asarray(fixed))
    Pt, Qt = torch.as_tensor(P), torch.as_tensor(Q)
    T_t, res_t = tlm.lm_solve(
        lambda T: (tse3.act(T, Pt) - Qt).reshape(-1), torch.as_tensor(T0),
        tse3.right_plus, 6, tlm.LMConfig(**kw),
        fixed_mask=torch.as_tensor(fixed))

    # Huber keeps the 4 outliers from pulling the fit off the truth
    assert float(res_t.cost) < float(res_t.initial_cost)
    err = tse3.log(tse3.compose(tse3.inverse(torch.as_tensor(T_true)), T_t))
    assert float(err.abs().max()) < 0.01, err
    assert res_t.iterations == int(res_j.iterations)
    np.testing.assert_allclose(float(res_t.cost), float(res_j.cost),
                               rtol=1e-10)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-10)


@pytest.mark.parametrize("delta,block", [(0.5, 2), (2.0, 3)])
def test_huber_weights_and_cost_match_jax(delta, block):
    r = np.random.default_rng(3).normal(0, 1.5, 12 * block)
    np.testing.assert_allclose(
        tlm.huber_weights(torch.as_tensor(r), delta, block).numpy(),
        np.asarray(jlm.huber_weights(jnp.asarray(r), delta, block)),
        rtol=1e-14)
    np.testing.assert_allclose(
        float(tlm.huber_cost(torch.as_tensor(r), delta, block)),
        float(jlm.huber_cost(jnp.asarray(r), delta, block)), rtol=1e-14)


def test_entry_matches_graft_entry():
    """The port's entry step against ``__graft_entry__.entry`` on the same
    problem (both generated from seed 0 in f32)."""
    jstep, (jprob,) = __graft_entry__.entry()
    tstep, (tprob,) = tentry.entry(device="cpu")
    np.testing.assert_allclose(tprob.inv_depth.numpy(),
                               np.asarray(jprob.inv_depth), rtol=1e-6)
    jc, jdc, jdp = jstep(jprob)
    tc, tdc, tdp = tstep(tprob)
    assert tdc.shape == (4, 8) and tdp.shape == (256,)
    assert torch.isfinite(tdc).all() and torch.isfinite(tdp).all()
    np.testing.assert_allclose(float(tc), float(jc), rtol=2e-4)
    for t, j in ((tdc, jdc), (tdp, jdp)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=2e-3,
                                   atol=2e-3 * np.abs(j).max())


def test_photometric_make_solver_matches_jax():
    """``make_solver`` (scatter-add build, ``schur_solve``, classic loop)
    on ``synth_pba_problem(K=4, L=64)`` in f64: the cost falls and the
    final cost matches the JAX ``make_solver``."""
    jprob, images, H, W, _, _ = jsyn.synth_pba_problem(K=4, L=64,
                                                      dtype=jnp.float64)
    cfg_j = jba.BAConfig(max_iterations=5, huber_delta=9.0)
    _, res_j = jpba.make_solver("pinhole", images, H, W)(jprob, cfg_j)
    tprob = interop.problem_from_numpy(jprob, "cpu")
    solve = tpba.make_solver("pinhole", interop.array_from_numpy(images, "cpu"),
                             H, W, device="cpu")
    _, res_t = solve(tprob, tba.BAConfig(max_iterations=5, huber_delta=9.0))
    assert float(res_t.cost) < float(res_t.initial_cost)
    np.testing.assert_allclose(float(res_t.initial_cost),
                               float(res_j.initial_cost), rtol=1e-10)
    np.testing.assert_allclose(float(res_t.cost), float(res_j.cost),
                               rtol=2e-4)
