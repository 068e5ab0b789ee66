"""Parity of the port's plane-layout geometric build (ops/geo_mega.py) with
the JAX package's, and of its fixed-order sums with the scatter-add
reference, on ``synth_ba_problem`` at toy size.

The builds are held to the JAX builds in f32 at the JAX package's own
tolerances (tests/test_geo_mega.py:31-50: cost rtol 1e-5, pieces atol
2e-4 x max|ref| with rtol 1e-3), the JAX dense build made camera-major
(``_camera_major``: the JAX dense family solves a component-major system
with the coupling scaled by sqrt(inv0)); the port's damped solve on those
normal equations against the JAX ``solve_lam2``'s deltas at 2e-3 x
max|ref| (f32), full solves at final cost rtol 2e-4.  In f64 every build
of the port (``build_geo`` with either plan family and the fused chunk and
dense builds) sums to what ``make_ba_step``'s ``index_add_`` gives, to
1e-10 relative.
"""

import ast
import inspect
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.models import synthetic as jsyn
from photometric_bundle_adjustment_tpu.optim import ba as jba
from photometric_bundle_adjustment_tpu.optim import fused as jfused
from photometric_bundle_adjustment_tpu.ops import geo_mega as jgm
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.models import geometric_ba as tgeo
from photometric_bundle_adjustment_tpu_torch.ops import geo_mega as tgm
from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
from photometric_bundle_adjustment_tpu_torch.optim import ba as tba
from photometric_bundle_adjustment_tpu_torch.optim import fused as tfused

torch.set_num_threads(1)

K, L, S = 12, 96, 4
C = 6
CHUNK_NAMES = ["H_cc", "S_corr0", "rhs_corr0", "H_pp", "g_c", "g_p", "M",
               "inv0"]
OPS = pathlib.Path(tgm.__file__).parent


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close_scaled(port, ref, frac, rtol=0.0, msg=""):
    port, ref = _np(port), _np(ref)
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(port, ref, atol=frac * scale, rtol=rtol,
                               err_msg=msg)


def _problem(dtype, seed=0, drop=False):
    """The JAX problem (f32 or f64; ``drop`` marks every 7th row invalid,
    so the dense layout has empty slots) and the port's copy."""
    jdt = jnp.float32 if dtype == "f32" else jnp.float64
    jp, _, _ = jsyn.synth_ba_problem("pinhole", K=K, L=L, obs_per_landmark=S,
                                     pixel_noise=0.6, seed=seed, dtype=jdt)
    if drop:
        valid = np.ones(np.shape(jp.obs.valid), bool)
        valid[::7] = False
        jp = jp._replace(obs=jp.obs._replace(valid=jnp.asarray(valid, jdt)))
    return jp, interop.geometric_problem_from_numpy(jp, "cpu")


@pytest.fixture(scope="module")
def f32():
    return _problem("f32", seed=1, drop=True)


def test_build_geo_matches_jax(f32):
    jp, tp = f32
    cfg = jba.BAConfig(huber_delta=1.0)
    ref_cost, ref = jgm.make_geo_solver("pinhole", jp).build(jp, cfg)
    cost, neq = tgm.make_geo_solver("pinhole", tp, device="cpu").build(
        tp, tba.BAConfig())
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=1e-5)
    for name, a, b in zip(CHUNK_NAMES, neq, ref):
        _close_scaled(a, b, 2e-4, rtol=1e-3, msg=name)


def _dense_pair(jp, tp):
    jpd, jplan = jfused.densify_problem(jp, pow2_buckets=False)
    tpd, tplan = tfused.densify_problem(tp, pow2_buckets=False)
    return (jgm.make_geo_solver("pinhole", jpd, jplan), jpd,
            tgm.make_geo_solver("pinhole", tpd, tplan, device="cpu"), tpd)


def _camera_major(neq):
    """The JAX dense build's normal equations (H_cc, S_corr0, rhs_corr0
    over rows c*K + k, g_c (C, K), g_p, Ms_p = (sqrt(inv0) M)^T (C*K, L),
    inv0, s) as the port's camera-major pieces, numpy, by name (no H_pp:
    the JAX build does not return it)."""
    H, S, rhs, g_c, g_p, Ms_p, inv0, s = (np.asarray(a) for a in neq)

    def rows(X):
        return X.reshape(C, K, C, K).transpose(1, 0, 3, 2).reshape(K * C, -1)

    M = (Ms_p.T / s[:, None]).reshape(L, C, K).transpose(0, 2, 1)
    return dict(H_cc=rows(H), S_corr0=rows(S),
                rhs_corr0=rhs.reshape(C, K).T.reshape(-1), g_c=g_c.T,
                g_p=g_p, M=M.reshape(L, K * C), inv0=inv0)


def test_build_geo_dense2_matches_jax(f32):
    """The dense family's build against the JAX dense build, made
    camera-major."""
    jsolve, jpd, tsolve, tpd = _dense_pair(*f32)
    ref_cost, ref = jsolve.build(jpd, jba.BAConfig(huber_delta=1.0))
    cost, neq = tsolve.build(tpd, tba.BAConfig())
    assert (np.asarray(jpd.obs.valid) == 0).any()
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=1e-5)
    got = dict(zip(CHUNK_NAMES, neq))
    for name, b in _camera_major(ref).items():
        assert got[name].shape == b.shape, name
        _close_scaled(got[name], b, 2e-4, rtol=1e-3, msg=name)


@pytest.mark.parametrize("fixed", [(0, 1), (0, 3)])
def test_solve_lam2_matches_jax(f32, fixed):
    """The port's damped solve (``fused.solve_lam``) on the JAX dense
    build's normal equations made camera-major, against the JAX
    ``solve_lam2``, with the gauge on cameras {0, 1} and {0, 3} (a mix-up
    of camera- and component-major rows cannot pass both)."""
    jsolve, jpd, tsolve, _ = _dense_pair(*f32)
    _, ref = jsolve.build(jpd, jba.BAConfig(huber_delta=1.0))
    cm = {k: interop.array_from_numpy(v, "cpu")
          for k, v in _camera_major(ref).items()}
    neq = tuple(cm.get(name) for name in CHUNK_NAMES)       # H_pp: None
    free = np.ones(K, bool)
    free[list(fixed)] = False
    for lam in (1e-4, 1e-1):
        dc_j, dp_j = jgm.solve_lam2(ref, jnp.asarray(lam, jnp.float32),
                                    jnp.asarray(free), jba.BAConfig())
        dc, dp = tsolve.solve_lam(neq, lam, torch.as_tensor(free),
                                  tba.BAConfig())
        assert dc.shape == (K, C)
        assert (dc[torch.as_tensor(~free)] == 0).all()
        _close_scaled(dc, dc_j, 2e-3, msg=f"delta_c at lambda {lam}")
        _close_scaled(dp, dp_j, 2e-3, msg=f"delta_p at lambda {lam}")


@pytest.mark.parametrize("family", ["chunk", "dense"])
def test_geo_solver_matches_jax(f32, family):
    """``make_geo_solver``'s fused-cost loop against the JAX one, 6
    iterations, Huber 1: the cost falls, the final costs agree."""
    jp, tp = f32
    cfg = dict(max_iterations=6, huber_delta=1.0)
    if family == "chunk":
        jsolve, jprob = jgm.make_geo_solver("pinhole", jp), jp
        tsolve = tgm.make_geo_solver("pinhole", tp, device="cpu")
        tprob = tp
    else:
        jsolve, jprob, tsolve, tprob = _dense_pair(jp, tp)
    _, ref = jsolve(jprob, jba.BAConfig(**cfg))
    _, res = tsolve(tprob, tba.BAConfig(**cfg))
    assert float(res.cost) < float(res.initial_cost)
    assert res.builds == res.tries + 1
    np.testing.assert_allclose(float(res.initial_cost),
                               float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=2e-4)


def _scatter_reference(tp):
    """cost, H_cc (K*C, K*C) camera-major, H_pp, g_c (K, C), g_p and M
    (L, K*C) from ``make_ba_step``'s ``index_add_`` build."""
    _, build = tba.make_ba_step(tgeo.make_residual_fn("pinhole"),
                                tgeo.cam_retract, C,
                                rj_fn=tgeo.make_rj_fn("pinhole"))
    cost, H_cc, H_cp, H_pp, g_c, g_p = build(tp, tba.BAConfig())
    return dict(cost=cost,
                H_cc=H_cc.permute(0, 2, 1, 3).reshape(K * C, K * C),
                H_pp=H_pp, g_c=g_c, g_p=g_p,
                M=H_cp.permute(1, 0, 2).reshape(L, K * C))


@pytest.mark.parametrize("build", ["build_geo", "build_geo_dense2",
                                   "fused_chunk", "fused_dense"])
def test_fixed_order_sums_equal_scatter_add(build):
    """Every plan-based build sums to the scatter-add reference (f64):
    ``build_geo`` with the chunk plan and with the dense plan
    (``build_geo_dense2``), and the fused solver's two builds."""
    _, tp = _problem("f64", seed=2, drop=True)
    ref = _scatter_reference(tp)
    cfg = tba.BAConfig()
    if build in ("build_geo", "fused_chunk"):
        prob, plan = tp, tfused.plan_for_problem(tp, pow2_buckets=False)
    else:
        prob, plan = tfused.densify_problem(tp, pow2_buckets=False)
    if build.startswith("fused"):
        cost, neq = tgeo.make_fused_solver("pinhole").build(prob, plan, cfg)
        got = dict(zip(CHUNK_NAMES, neq))
    else:
        solve = tgm.make_geo_solver("pinhole", prob,
                                    None if build == "build_geo" else plan,
                                    device="cpu")
        cost, neq = solve.build(prob, cfg)
        got = dict(zip(CHUNK_NAMES, neq))
    np.testing.assert_allclose(float(cost), float(ref["cost"]), rtol=1e-12)
    for name in ("H_cc", "H_pp", "g_c", "g_p", "M"):
        _close_scaled(got[name], ref[name], 1e-10, rtol=1e-10,
                      msg=f"{build} {name}")


@pytest.mark.parametrize("fn", [
    tgm.build_geo, tgm._geo_payload, tfused.make_fused_ba_solver,
    tfused.tree_sum, tfused._chunk_sum, tfused.pair_gram, tfused.assemble,
    pba_mega.build_mega, pba_mega.mega_rj_reference])
def test_builds_have_no_scatter_add(fn):
    """No build of the port sums with atomics on the card: no
    ``index_add_``, ``scatter_add_`` or accumulating ``index_put_``."""
    src = inspect.getsource(fn)
    for word in ("index_add", "scatter_add", "index_put", "accumulate="):
        assert word not in src, f"{fn.__name__} uses {word}"


def test_ops_use_only_the_public_assembly():
    """The builds of ``ops/`` reach the assembly through ``optim/fused``'s
    public names: ``geo_mega`` imports nothing from its photometric
    sibling ``pba_mega``, and no module of ``ops/`` imports or reads a
    ``_``-prefixed name of ``optim/fused``."""
    for path in sorted(OPS.glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                names = [a.name for a in node.names]
                if path.name == "geo_mega.py":
                    assert not node.module.endswith("pba_mega"), path.name
                    assert "pba_mega" not in names, path.name
                if node.module.endswith("optim.fused"):
                    private = [n for n in names if n.startswith("_")]
                    assert not private, f"{path.name} imports {private}"
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)):
                if path.name == "geo_mega.py":
                    assert node.value.id != "pba_mega", path.name
                if node.value.id == "fused":
                    assert not node.attr.startswith("_"), \
                        f"{path.name} reads fused.{node.attr}"


def test_dense_equals_chunk_family(f32):
    """The dense family's first build and damped solve equal the chunk
    family's on the same problem (f32; the JAX package's
    test_geo_plane_dense_matches_chunk tolerances)."""
    _, tp = f32
    cfg = tba.BAConfig()
    chunk = tgm.make_geo_solver("pinhole", tp, device="cpu")
    cost_c, neq_c = chunk.build(tp, cfg)
    _, _, dense, tpd = _dense_pair(*f32)
    cost_d, neq_d = dense.build(tpd, cfg)
    np.testing.assert_allclose(float(cost_d), float(cost_c), rtol=1e-6)
    free = ~tp.fixed_cams
    for a, b in zip(dense.solve_lam(neq_d, 1e-4, free, cfg),
                    chunk.solve_lam(neq_c, 1e-4, free, cfg)):
        _close_scaled(a, b, 1e-3)
