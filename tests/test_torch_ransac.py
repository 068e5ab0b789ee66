"""The port's batched RANSAC against the JAX package's, and on its own.

``jax.random`` cannot be reproduced, so the parity tests inject the JAX
package's own draws (``ransac._sample_indices`` of the key it used) into
the port: ``ransac_relative_pose`` (both solvers) and ``ransac_pnp``
(both solvers) at M = 128 correspondences and H = 16 hypotheses, three
problems batched on the port's side, each a JAX call of its own; then
``make_pair_matcher`` against the JAX package's on a chunk of pairs.  In
f64 the inlier masks are equal and the poses agree within 1e-8.

Then the batched LM against the unbatched ``lm_solve``, element by
element; one pair's result unchanged by the chunk it sits in;
``_sample_indices``' properties; and the outcome tests of the JAX
package's tests/test_features.py on the port alone, drawing from torch
generators, with hypothesis counts that make a clean sample all but
certain."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.core import se3 as jse3
from photometric_bundle_adjustment_tpu.features import (
    pair_matching as jpair_matching,
)
from photometric_bundle_adjustment_tpu.features import ransac as jransac
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.core import se3
from photometric_bundle_adjustment_tpu_torch.features import pair_matching, ransac
from photometric_bundle_adjustment_tpu_torch.optim import lm

torch.set_num_threads(1)

M, H, B = 128, 16, 3
SAMPLE = {"nister": 5, "eight_point": 8, "p3p": 3, "dlt": 6}


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def make_two_view(M=120, outlier_frac=0.25, seed=0):
    """Bearings of M points seen from two cameras (T_0_1 fixed), the first
    ``outlier_frac`` of f1 replaced by random directions; returns
    (T_0_1 (7,), f0, f1, is_inlier) as numpy."""
    rng = np.random.default_rng(seed)
    T = np.asarray(jse3.exp(jnp.asarray([0.4, 0.05, -0.1, 0.02, -0.04, 0.03])))
    p1 = np.stack([rng.uniform(-2, 2, M), rng.uniform(-2, 2, M),
                   rng.uniform(3, 12, M)], -1)
    p0 = np.asarray(jse3.act(jnp.asarray(T), jnp.asarray(p1)))
    f0 = p0 / np.linalg.norm(p0, axis=-1, keepdims=True)
    f1 = p1 / np.linalg.norm(p1, axis=-1, keepdims=True)
    n_out = int(M * outlier_frac)
    bad = rng.normal(size=(n_out, 3))
    bad[:, 2] = np.abs(bad[:, 2]) + 1
    f1[:n_out] = bad / np.linalg.norm(bad, axis=-1, keepdims=True)
    inl = np.ones(M, bool)
    inl[:n_out] = False
    return T, f0, f1, inl


def make_pnp(M=128, n_out=38, seed=0):
    """A camera T_w_c, bearings of M world points with the first n_out
    replaced by random directions in front; (T_w_c, f, p_w) as numpy."""
    rng = np.random.default_rng(seed)
    T_w_c = np.asarray(jse3.exp(jnp.asarray(
        np.array([0.3, -0.2, 0.1, 0.1, 0.05, -0.08]) * (1 + seed))))
    p_c = np.stack([rng.uniform(-2, 2, M), rng.uniform(-2, 2, M),
                    rng.uniform(2, 10, M)], -1)
    p_w = np.asarray(jse3.act(jnp.asarray(T_w_c), jnp.asarray(p_c)))
    f = p_c / np.linalg.norm(p_c, axis=-1, keepdims=True)
    bad = rng.normal(size=(n_out, 3))
    bad[:, 2] = np.abs(bad[:, 2]) + 0.5
    f[:n_out] = bad / np.linalg.norm(bad, axis=-1, keepdims=True)
    return T_w_c, f, p_w


def masks():
    valid = np.ones((B, M), bool)
    valid[1, -10:] = False
    valid[2, :5] = False
    return valid


@functools.cache
def relative_reference(solver):
    """B two-view problems, and the JAX package's RANSAC of each with the
    key PRNGKey(b): (f0, f1, valid, idx (B, H, s), T, inliers, n)."""
    data = [make_two_view(M, 0.25, s) for s in range(B)]
    f0 = np.stack([d[1] for d in data])
    f1 = np.stack([d[2] for d in data])
    valid = masks()
    out = []
    for b in range(B):
        key = jax.random.PRNGKey(b)
        idx = jransac._sample_indices(key, H, SAMPLE[solver],
                                      jnp.asarray(valid[b]))
        res = jransac.ransac_relative_pose(
            jnp.asarray(f0[b]), jnp.asarray(f1[b]), jnp.asarray(valid[b]),
            key, num_hypotheses=H, solver=solver)
        out.append((np.asarray(idx),) + tuple(np.asarray(x) for x in res))
    return (f0, f1, valid) + tuple(np.stack(x) for x in zip(*out))


@pytest.mark.parametrize("solver", ["nister", "eight_point"])
def test_relative_pose_matches_jax(solver):
    f0, f1, valid, idx, Tj, inl_j, n_j = relative_reference(solver)
    T, inl, n = ransac.ransac_relative_pose(
        t(f0), t(f1), t(valid), num_hypotheses=H, solver=solver,
        idx=interop.array_from_numpy(idx, "cpu", torch.int64))
    np.testing.assert_array_equal(inl.numpy(), inl_j)
    np.testing.assert_array_equal(n.numpy(), n_j)
    np.testing.assert_allclose(T.numpy(), Tj, atol=1e-8)
    assert (n_j > 80).all()


@pytest.mark.parametrize("solver", ["p3p", "dlt"])
def test_pnp_matches_jax(solver):
    data = [make_pnp(M, 38, s) for s in range(B)]
    f = np.stack([d[1] for d in data])
    pw = np.stack([d[2] for d in data])
    valid = masks()
    idx, Tj, inl_j = [], [], []
    for b in range(B):
        key = jax.random.PRNGKey(10 + b)
        idx.append(np.asarray(jransac._sample_indices(
            key, H, SAMPLE[solver], jnp.asarray(valid[b]))))
        T_b, inl_b = jransac.ransac_pnp(
            jnp.asarray(f[b]), jnp.asarray(pw[b]), jnp.asarray(valid[b]), key,
            num_hypotheses=H, solver=solver)
        Tj.append(np.asarray(T_b))
        inl_j.append(np.asarray(inl_b))
    T, inl = ransac.ransac_pnp(t(f), t(pw), t(valid), num_hypotheses=H,
                               solver=solver, idx=t(np.stack(idx)))
    np.testing.assert_array_equal(inl.numpy(), np.stack(inl_j))
    np.testing.assert_allclose(T.numpy(), np.stack(Tj), atol=1e-8)
    for b in range(B):
        err = se3.log(se3.compose(se3.inverse(t(data[b][0])), T[b]))
        assert float(torch.linalg.norm(err)) < 1e-6


def test_pair_matcher_matches_jax():
    """``make_pair_matcher`` on a chunk of pairs of planted matches with
    consistent bearings (every feature a world point seen by every
    camera), samples injected from the JAX chunk's per-pair keys."""
    rng = np.random.default_rng(2)
    I, F = 6, 64
    base = rng.integers(0, 2**32, (F, 8), dtype=np.uint32)
    desc = np.stack([base ^ (rng.random((F, 8)) < 0.02).astype(np.uint32)
                     for _ in range(I)])
    valid = np.ones((I, F), bool)
    X = rng.uniform(-2, 2, (F, 3)) + np.array([0, 0, 6.0])
    T_w_c = np.asarray(jse3.exp(jnp.asarray(rng.normal(0, 0.15, (I, 6)))))
    pc = np.asarray(jse3.act(jse3.inverse(jnp.asarray(T_w_c))[:, None],
                             jnp.asarray(X)[None]))
    bear = pc / np.linalg.norm(pc, axis=-1, keepdims=True)
    kw = dict(max_matches=32, match_max_dist=70, match_ratio=1.2,
              ransac_thresh=5e-5, ransac_min_inliers=8, ransac_hypotheses=H)
    i1 = np.array([1, 2, 3, 4, 5, 2], np.int32)
    i2 = np.array([0, 0, 1, 3, 0, 5], np.int32)
    key = jax.random.PRNGKey(7)
    ref = [np.asarray(x) for x in jpair_matching.make_pair_matcher(
        jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(bear), **kw)(
            jnp.asarray(i1), jnp.asarray(i2), key)]
    keys = jax.random.split(key, len(i1))
    idx = np.stack([np.asarray(jransac._sample_indices(
        k, H, 5, jnp.asarray(v))) for k, v in zip(keys, ref[1])])
    chunk = pair_matching.make_pair_matcher(
        interop.descriptors_from_numpy(desc, "cpu"), t(valid), t(bear), **kw)
    got = chunk(i1, i2, idx=t(idx))
    for g, r, name in zip(got, ref, ("pairs", "pvalid", "count", "T",
                                     "inliers", "n_inliers")):
        if name == "T":
            np.testing.assert_allclose(g.numpy(), r, atol=1e-8)
        else:
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    assert (ref[2] == 32).all() and (ref[5] >= 24).all(), ref[5]


def test_batched_lm_matches_unbatched():
    """``lm_solve_batched`` on 8 problems equals ``lm_solve`` on each:
    pose alignments from starts at different distances (one at the
    optimum, which stops after one rejected iteration), squared and Huber
    loss."""
    rng = np.random.default_rng(4)
    targets = se3.exp(t(rng.normal(0, 0.5, (8, 6))))
    scale = t([0.0, 1e-3, 0.01, 0.1, 0.3, 0.6, 1.0, 2.0])[:, None]
    starts = se3.right_plus(targets, scale * t(rng.normal(size=(8, 6))))
    weights = t(rng.uniform(0.5, 2.0, (8, 6)))
    for huber in (-1.0, 0.05):
        cfg = lm.LMConfig(max_iterations=12, huber_delta=huber, block_size=3)

        def residual(T, tg=targets, w=weights):
            return se3.log(se3.compose(se3.inverse(tg), T)) * w

        Tb, rb = lm.lm_solve_batched(residual, starts, se3.right_plus, 6, cfg)
        for k in range(8):
            Tk, rk = lm.lm_solve(
                lambda T: residual(T[None], targets[k:k + 1],
                                   weights[k:k + 1])[0],
                starts[k], se3.right_plus, 6, cfg)
            np.testing.assert_allclose(Tb[k].numpy(), Tk.numpy(), atol=1e-12)
            np.testing.assert_allclose(float(rb.cost[k]), float(rk.cost),
                                       rtol=1e-9, atol=1e-24)
            assert int(rb.iterations[k]) == rk.iterations
            np.testing.assert_allclose(float(rb.lam[k]), rk.lam, rtol=1e-12)
        assert int(rb.iterations[0]) == 1
        assert len(set(rb.iterations.tolist())) >= 3


def test_one_pair_unchanged_by_its_chunk():
    f0, f1, valid, idx, *_ = relative_reference("nister")
    args = (t(f0), t(f1), t(valid))
    whole = ransac.ransac_relative_pose(*args, num_hypotheses=H, idx=t(idx))
    for b in range(B):
        alone = ransac.ransac_relative_pose(
            *(x[b:b + 1] for x in args), num_hypotheses=H,
            idx=t(idx[b:b + 1]))
        for w, a in zip(whole, alone):
            assert torch.equal(w[b], a[0])


def test_sample_indices_properties():
    g = torch.Generator().manual_seed(0)
    valid = torch.ones(3, 40, dtype=torch.bool)
    valid[1, 10:] = False
    valid[2, ::2] = False
    idx = ransac._sample_indices(g, 4000, 5, valid)
    assert idx.shape == (3, 4000, 5) and idx.dtype == torch.int64
    # distinct within each sample, valid rows only
    s = torch.sort(idx, dim=-1).values
    assert bool((s[..., 1:] != s[..., :-1]).all())
    assert bool(torch.gather(valid[:, None].expand(-1, 4000, -1), 2,
                             idx).all())
    # roughly uniform over the valid rows: 4000 x 5 draws
    for b in range(3):
        counts = torch.bincount(idx[b].reshape(-1), minlength=40)[valid[b]]
        mean = 20000 / int(valid[b].sum())
        assert float((counts - mean).abs().max()) < 0.15 * mean
    # a generator in the same state draws the same samples
    again = ransac._sample_indices(torch.Generator().manual_seed(0), 4000, 5,
                                   valid)
    assert torch.equal(idx, again)
    with pytest.raises(ValueError):
        ransac.ransac_relative_pose(*(torch.zeros(1, 8, 3),) * 2,
                                    torch.ones(1, 8, dtype=torch.bool))


# ---------------------------------------------------------------------------
# the outcome tests of tests/test_features.py, on the port alone
# ---------------------------------------------------------------------------


def rotation_error(T, T_gt):
    return float(torch.linalg.norm(se3.so3_log(se3.quat_mul(
        se3.quat_conj(se3.rotation(T)), se3.rotation(T_gt)))))


def test_ransac_relative_pose():
    T_gt, f0, f1, gt_inl = make_two_view()
    T, inl, n = ransac.ransac_relative_pose(
        t(f0)[None], t(f1)[None], torch.ones(1, 120, dtype=torch.bool),
        torch.Generator().manual_seed(0), threshold=1e-7, min_inliers=16)
    assert int(n[0]) >= int(0.9 * gt_inl.sum())
    assert not inl[0].numpy()[~gt_inl].any()
    assert rotation_error(T[0], t(T_gt)) < 1e-3
    t_gt = t(T_gt[:3]) / np.linalg.norm(T_gt[:3])
    assert float(torch.linalg.norm(se3.translation(T[0]) - t_gt)) < 1e-3


def test_ransac_pnp():
    T_w_c, f, p_w = make_pnp(100, 30, seed=0)
    T_est, inl = ransac.ransac_pnp(t(f)[None], t(p_w)[None],
                                   torch.ones(1, 100, dtype=torch.bool),
                                   torch.Generator().manual_seed(1))
    err = se3.log(se3.compose(se3.inverse(t(T_w_c)), T_est[0]))
    assert float(torch.linalg.norm(err)) < 1e-3
    inl = inl[0].numpy()
    assert inl[30:].mean() > 0.95 and inl[:30].mean() < 0.1


def test_ransac_nister_beats_eight_point_at_high_outlier_rate():
    """62% outliers: a clean 5-point sample comes 1 in 126 draws, a clean
    8-point sample 1 in 2,340; at 1,024 hypotheses Nister misses with
    probability 3e-4, and the eight-point solver finds one 35% of the
    time."""
    rng = np.random.default_rng(5)
    n, n_out = 96, 60
    T = se3.exp(t([0.4, 0.1, -0.2, 0.05, -0.03, 0.08]))
    p1 = t(rng.uniform(-1.5, 1.5, (n, 3)) + np.array([0, 0, 5.0]))
    f1 = p1 / torch.linalg.norm(p1, dim=-1, keepdim=True)
    p0 = se3.act(T, p1)
    f0 = p0 / torch.linalg.norm(p0, dim=-1, keepdim=True)
    bad = rng.permutation(n)[:n_out]
    fb = rng.normal(size=(n_out, 3))
    f1[bad] = t(fb / np.linalg.norm(fb, axis=-1, keepdims=True))
    valid = torch.ones(1, n, dtype=torch.bool)
    counts = {}
    for solver in ("nister", "eight_point"):
        _, _, n_inl = ransac.ransac_relative_pose(
            f0[None], f1[None], valid, torch.Generator().manual_seed(0),
            num_hypotheses=1024, solver=solver)
        counts[solver] = int(n_inl[0])
    assert counts["nister"] >= 30, counts
    assert counts["nister"] >= counts["eight_point"], counts


def test_ransac_pnp_p3p_beats_dlt_at_high_outlier_rate():
    """65% outliers: a clean 3-point sample comes 1 in 23 draws, a clean
    6-point sample 1 in 544; at 256 hypotheses P3P misses with
    probability 1e-5."""
    rng = np.random.default_rng(11)
    n, n_out = 120, 78
    T_c_w = se3.exp(t([0.3, -0.2, 0.4, 0.1, 0.05, -0.07]))
    Pw = t(rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 7.0]))
    Pc = se3.act(T_c_w, Pw)
    f = (Pc / torch.linalg.norm(Pc, dim=-1, keepdim=True)).numpy()
    bad = rng.permutation(n)[:n_out]
    fb = rng.normal(size=(n_out, 3))
    f[bad] = fb / np.linalg.norm(fb, axis=-1, keepdims=True)
    f[bad, 2] = np.abs(f[bad, 2])
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    valid = torch.ones(1, n, dtype=torch.bool)
    counts = {}
    for solver in ("p3p", "dlt"):
        _, inl = ransac.ransac_pnp(t(f)[None], Pw[None], valid,
                                   torch.Generator().manual_seed(2),
                                   num_hypotheses=256, solver=solver)
        counts[solver] = int(inl.sum())
    assert counts["p3p"] >= 0.9 * (n - n_out), counts
    assert counts["p3p"] >= counts["dlt"], counts


def test_ransac_cpu_script_on_plain_path():
    """The script behind the chip runs' predictions runs on the CPU at a
    toy size and reports its counts and errors."""
    from photometric_bundle_adjustment_tpu_torch.scripts import ransac_cpu

    res = ransac_cpu.main(["--device", "cpu", "--ops-pairs", "2",
                           "--frames", "2", "--H", "240", "--W", "376",
                           "--pairs", "4"])
    assert res["device"] == "cpu" and res["pairs"] == 4
    assert res["chunk_ops"] > 1000 and 0 < res["succeeded"] <= 4
    for k in ("rotation_median", "rotation_p95", "direction_median",
              "direction_p95", "inliers_on_truth"):
        assert np.isfinite(res[k]), k
