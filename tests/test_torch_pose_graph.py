"""The port's pose graphs (``models/pose_graph.py``) against the JAX
package's, on the CPU in f64.

The three problems of tests/test_pose_graph.py (rotation averaging,
translation averaging, the SE3 pose graph), rebuilt from numpy seeds and
solved by both packages from the same start: final states within 1e-8,
costs within rtol 1e-8, and each within the JAX test's error bound of
the ground truth.  Then translation averaging with metric edges, and the
rotation averaging of a graph with wrong edges, where the Huber blocks
decide the answer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.models import pose_graph as jpg
from photometric_bundle_adjustment_tpu_torch.core import se3
from photometric_bundle_adjustment_tpu_torch.models import pose_graph as pg

torch.set_num_threads(1)

ATOL, RTOL = 1e-8, 1e-8


def random_graph(N, extra_edges, seed):
    """A chain plus random extra edges (tests/test_pose_graph.py)."""
    rng = np.random.default_rng(seed)
    edges = [(i, i + 1) for i in range(N - 1)]
    while len(edges) < N - 1 + extra_edges:
        i, j = rng.integers(0, N, 2)
        if i != j and (i, j) not in edges and (j, i) not in edges:
            edges.append((int(i), int(j)))
    return np.array(edges, np.int64), rng


def t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def both(port_graph_type, jax_graph_type, fields):
    """The same graph for both packages from numpy fields."""
    return (port_graph_type(**{k: torch.as_tensor(v) for k, v in
                               fields.items()}),
            jax_graph_type(**{k: jnp.asarray(v) for k, v in fields.items()}))


def rotation_problem(N=12, seed=0, wrong=0):
    edges, rng = random_graph(N, 18, seed)
    q_gt = se3.so3_exp(t(rng.normal(0, 0.5, (N, 3)))).numpy()
    q_gt[0] = [0, 0, 0, 1.0]
    i, j = edges[:, 0], edges[:, 1]
    q_ij = se3.quat_mul(se3.quat_conj(t(q_gt[i])), t(q_gt[j]))
    noise = se3.so3_exp(t(rng.normal(0, 0.01, (len(edges), 3))))
    q_ij = se3.quat_mul(q_ij, noise).numpy()
    if wrong:
        q_ij[-wrong:] = se3.so3_exp(t(rng.normal(0, 1.5, (wrong, 3)))).numpy()
    q0 = se3.quat_mul(t(q_gt), se3.so3_exp(t(rng.normal(0, 0.2, (N, 3)))))
    q0 = q0.numpy()
    q0[0] = q_gt[0]
    fixed = np.zeros(N, bool)
    fixed[0] = True
    fields = dict(edge_i=i, edge_j=j, q_ij=q_ij, weight=np.ones(len(edges)))
    return q_gt, q0, fixed, fields


def assert_same(got, want, gt_err, bound):
    (x_t, r_t), (x_j, r_j) = got, want
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(r_t.cost), float(r_j.cost), rtol=RTOL,
                               atol=1e-20)
    np.testing.assert_allclose(float(r_t.initial_cost),
                               float(r_j.initial_cost), rtol=RTOL)
    assert float(r_t.cost) < float(r_t.initial_cost)
    assert gt_err(x_t) < bound


def rot_err(q_gt):
    def err(q):
        d = se3.so3_log(se3.quat_mul(se3.quat_conj(t(q_gt)), q))
        return float(d.norm(dim=-1).max())
    return err


@pytest.mark.parametrize("wrong", [0, 3])
def test_rotation_averaging_matches_jax(wrong):
    """``wrong`` replaces the last edges by random rotations: the Huber
    blocks (delta 0.05) keep the estimate near the truth."""
    q_gt, q0, fixed, fields = rotation_problem(wrong=wrong)
    g_t, g_j = both(pg.RotationGraph, jpg.RotationGraph, fields)
    got = pg.rotation_averaging(t(q0), g_t, torch.as_tensor(fixed))
    want = jpg.rotation_averaging(jnp.asarray(q0), g_j, jnp.asarray(fixed))
    assert_same(got, want, rot_err(q_gt), 0.03 if not wrong else 0.1)


def translation_problem(N=12, seed=1):
    edges, rng = random_graph(N, 18, seed)
    t_gt = rng.normal(0, 2.0, (N, 3))
    i, j = edges[:, 0], edges[:, 1]
    diff = t_gt[j] - t_gt[i]
    t_hat = diff / (np.linalg.norm(diff, axis=-1, keepdims=True) + 1e-6)
    t0 = t_gt + rng.normal(0, 0.3, (N, 3))
    t0[:2] = t_gt[:2]
    fixed = np.zeros(N, bool)
    fixed[:2] = True
    fields = dict(edge_i=i, edge_j=j, t_hat_ij=t_hat,
                  weight=np.ones(len(edges)))
    return t_gt, t0, fixed, fields, rng


@pytest.mark.parametrize("with_metric", [False, True])
def test_translation_averaging_matches_jax(with_metric):
    """Directions alone, then with metric edges on three pairs (weight 10,
    as ``global_init`` sets them)."""
    t_gt, t0, fixed, fields, rng = translation_problem()
    g_t, g_j = both(pg.TranslationGraph, jpg.TranslationGraph, fields)
    m_t = m_j = None
    if with_metric:
        mi, mj = np.array([2, 5, 7]), np.array([3, 6, 11])
        m_t, m_j = both(pg.MetricEdges, jpg.MetricEdges, dict(
            edge_i=mi, edge_j=mj, t_ij_world=t_gt[mj] - t_gt[mi],
            weight=np.full(3, 10.0)))
    got = pg.translation_averaging(t(t0), g_t, torch.as_tensor(fixed),
                                   metric=m_t)
    want = jpg.translation_averaging(jnp.asarray(t0), g_j,
                                     jnp.asarray(fixed), metric=m_j)
    assert_same(got, want,
                lambda x: float((x - t(t_gt)).norm(dim=-1).max()), 0.05)


def test_se3_pose_graph_matches_jax():
    N = 10
    edges, rng = random_graph(N, 12, 2)
    xi = rng.normal(0, 0.4, (N, 6))
    xi[0] = 0
    T_gt = se3.exp(t(xi))
    i, j = edges[:, 0], edges[:, 1]
    T_ij = se3.compose(se3.inverse(T_gt[i]), T_gt[j]).numpy()
    dpose = rng.normal(0, 0.1, (N, 6))
    dpose[0] = 0
    T0 = se3.right_plus(T_gt, t(dpose)).numpy()
    fixed = np.zeros(N, bool)
    fixed[0] = True
    g_t, g_j = both(pg.PoseGraph, jpg.PoseGraph, dict(
        edge_i=i, edge_j=j, T_ij=T_ij, weight=np.ones(len(edges))))
    got = pg.pose_graph_optimization(t(T0), g_t, torch.as_tensor(fixed))
    want = jpg.pose_graph_optimization(jnp.asarray(T0), g_j,
                                       jnp.asarray(fixed))

    def err(T):
        return float(se3.log(se3.compose(se3.inverse(T_gt), T))
                     .norm(dim=-1).max())

    (x_t, r_t), (x_j, r_j) = got, want
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=ATOL)
    # both reach the noise-free optimum: costs are rounding, compared
    # absolutely
    assert float(r_t.cost) < 1e-20 and float(r_j.cost) < 1e-20
    np.testing.assert_allclose(float(r_t.initial_cost),
                               float(r_j.initial_cost), rtol=RTOL)
    assert err(x_t) < 1e-6
