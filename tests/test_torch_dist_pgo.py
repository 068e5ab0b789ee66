"""The port's edge-sharded pose-graph optimisation (``parallel/dist_pgo``)
on the CPU (Gloo, D = 4 spawned ranks) against the port's single-device
``pose_graph_optimization``, on tests/test_dist_pgo.py's problems (its
``_problem``, built on ``tests.test_pose_graph.random_graph``), in f64 at
that file's bounds: the final cost at most the single-device cost x
(1 + 1e-6), every pose within 1e-5 (tangent norm of the difference), the
noise-free graph recovered within 1e-6; the ranks end with bit-equal
poses.  ``prepare`` pads the edges to a multiple of D with weight-0
identity edges."""

import datetime

import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu_torch.core import se3
from photometric_bundle_adjustment_tpu_torch.models import pose_graph as pg
from photometric_bundle_adjustment_tpu_torch.optim.lm import LMConfig
from photometric_bundle_adjustment_tpu_torch.parallel import dist_pgo, mesh
from tests.test_dist_pgo import _problem

torch.set_num_threads(1)

D = 4
CFG = LMConfig(max_iterations=50, function_tolerance=1e-16)


def _port(problem):
    """The JAX problem's arrays as f64 numpy and the port's graph."""
    T_gt, T0, graph, fixed = problem
    g = pg.PoseGraph(*(torch.tensor(np.asarray(x)) for x in graph))
    return np.asarray(T_gt), np.asarray(T0), g, np.asarray(fixed)


@pytest.fixture(scope="module")
def cases():
    noisy = _port(_problem())
    clean = _port(_problem(N=10, extra_edges=12, seed=2, noise=0.0))
    calls = [(dist_pgo.solve_rank, (dist_pgo.prepare(c[2], D), c[1], c[3],
                                    CFG), {}) for c in (noisy, clean)]
    outs = mesh.spawn(mesh.run_calls, D, calls, device="cpu",
                      timeout=datetime.timedelta(seconds=60),
                      wall_limit=600.0, threads=1, log=lambda s: None)
    return dict(noisy=(noisy, outs[0]), clean=(clean, outs[1]))


def _err(a, b):
    return torch.linalg.norm(se3.log(se3.compose(
        se3.inverse(torch.as_tensor(a)), torch.as_tensor(b))), dim=-1).numpy()


def test_prepare_pads_edges():
    _, _, g, _ = _port(_problem())
    E = g.edge_i.shape[0]
    sh = dist_pgo.prepare(g, D)
    E_pad = sh.graph.edge_i.shape[0]
    assert E_pad % D == 0 and E <= E_pad < E + D
    assert (sh.graph.weight[E:] == 0).all()
    np.testing.assert_array_equal(sh.graph.T_ij[E:, :6], 0)
    np.testing.assert_array_equal(sh.graph.T_ij[E:, 6], 1)
    shards = [sh.shard(r, "cpu") for r in range(D)]
    assert sum(s.edge_i.shape[0] for s in shards) == E_pad


def test_dist_pgo_matches_single_device(cases):
    (_, T0, g, fixed), out = cases["noisy"]
    T_ref, res = pg.pose_graph_optimization(torch.as_tensor(T0), g, fixed)
    c0, c1, iters = out["stats"]
    assert iters > 0 and c1 < c0
    assert c1 <= float(res.cost) * (1 + 1e-6) + 1e-12
    assert _err(T_ref.numpy(), out["poses"]).max() < 1e-5
    assert out["ranks_bit_equal"]
    # one psum of (cost, H, g) per build, K^2 36 + 6K + 1 doubles
    K = T0.shape[0]
    assert out["bytes"]["build.psum"] == out["calls"]["build.psum"] * 8 * (
        1 + 36 * K * K + 6 * K)


def test_dist_pgo_noise_free_recovers_gt(cases):
    (T_gt, _, _, _), out = cases["clean"]
    c0, c1, _ = out["stats"]
    assert _err(T_gt, out["poses"]).max() < 1e-6
    assert c1 < 1e-12 * max(c0, 1.0)
    assert out["ranks_bit_equal"]
