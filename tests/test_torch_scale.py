"""The port's scale script (``scripts/scale_stress.py``) against the JAX
package's on the CPU, and the room-sphere guard of ``synth_pba_pipe``.

* ``SIZES`` and ``mem_model`` equal the root script's at D = 1 and 8.
* ``run_one`` at a toy size with 8 Gloo ranks, in each reduced-system
  mode, against the root script's ``run_one`` on the 8 CPU devices of
  ``tests/conftest.py``: the same observations, the initial cost within
  1e-6 relative, the final cost within 5e-4 (f32 after 2 iterations; the
  two packages sum in other orders, and the spread grows with each
  accepted step), the CG iterations within 2 (the PCG stops on an f32
  residual test, which one rounding flip moves by an iteration).
* In f64 the single-device solve and ``run_one`` at D = 1 in both modes
  end within 1e-8 relative of each other.
* ``main`` prints its table.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu_torch.models import (
    geometric_ba,
    synthetic,
)
from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
from photometric_bundle_adjustment_tpu_torch.scripts import scale_stress

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOY = (24, 384, 4)


@pytest.fixture(scope="module")
def jax_script():
    """The root ``scripts/scale_stress.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_scale_stress", ROOT / "scripts" / "scale_stress.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sizes_and_mem_model_match_jax(jax_script):
    assert scale_stress.SIZES == jax_script.SIZES
    for K, L, opl in jax_script.SIZES.values():
        for D in (1, 8):
            assert (scale_stress.mem_model(K, L, L * opl, D)
                    == jax_script.mem_model(K, L, L * opl, D))


@pytest.mark.parametrize("mode", ["replicated", "partitioned"])
def test_run_one_matches_jax(jax_script, mode):
    K, L, opl = TOY
    j = jax_script.run_one(K, L, opl, mode)
    t = scale_stress.run_one(K, L, opl, mode, ranks=8, device="cpu")
    assert t.O == j[0] == L * opl
    np.testing.assert_allclose(t.initial_cost, j[3], rtol=1e-6)
    np.testing.assert_allclose(t.cost, j[4], rtol=5e-4)
    assert t.ok and j[5]
    assert abs(t.cg - j[6]) <= 2, (t.cg, j[6])
    assert (t.cg > 0) == (mode == "partitioned")
    assert t.ranks_bit_equal and t.peak_bytes == 0 and t.backend == "gloo"


def test_paths_agree_in_f64():
    """The single-device solve (``bundle_adjustment``: the dense family
    here) and ``run_one`` at D = 1, replicated and partitioned."""
    K, L, opl = TOY
    problem, _, _ = synthetic.synth_ba_problem(
        "pinhole", K, L, opl, pixel_noise=0.5, dtype=torch.float64,
        device="cpu")
    _, res = geometric_ba.bundle_adjustment(
        problem, "pinhole", ba.BAConfig(max_iterations=2, huber_delta=1.0))
    single = float(res.cost)
    for mode in ("replicated", "partitioned"):
        r = scale_stress.run_one(K, L, opl, mode, ranks=1, device="cpu",
                                 dtype=torch.float64)
        np.testing.assert_allclose(r.initial_cost, float(res.initial_cost),
                                   rtol=1e-12)
        np.testing.assert_allclose(r.cost, single, rtol=1e-8, err_msg=mode)
        assert r.ok and r.ranks_bit_equal


def test_main_prints_its_table(capsys):
    rows = scale_stress.main(["--sizes", "small", "--iters", "1",
                              "--device", "cpu", "--ranks", "2"])
    out = capsys.readouterr().out
    assert [(n, m) for n, m, _ in rows] == [("small", "replicated"),
                                            ("small", "partitioned")]
    assert all(r.ok and r.O == 8192 * 6 for _, _, r in rows)
    lines = out.splitlines()
    assert "backend gloo" in lines[0] and "peak_MiB" in lines[1]
    assert len([s for s in lines if re.match(r"\s+small\s+200\s+8192\s+49152",
                                             s)]) == 2
    assert "per-device MB: build=" in lines[-1]


def test_synth_pba_pipe_refuses_cameras_outside_the_room():
    """K = 1,024 puts the sweep's end cameras outside the room sphere,
    where rays miss it: refused, naming the largest K that fits.  K = 960
    renders every pixel from the texture (its range is 28 to 228)."""
    fits = synthetic.max_room_images()
    assert 960 <= fits < 1024
    with pytest.raises(ValueError, match=f"largest K that fits is {fits}"):
        synthetic.synth_pba_pipe(K=1024, L=8, H=64, W=96)
    synthetic.synth_pba_pipe(K=fits, L=8, H=16, W=24)
    with pytest.raises(ValueError, match="outside its sphere"):
        synthetic.synth_pba_pipe(K=fits + 2, L=8, H=16, W=24)
    pipe = synthetic.synth_pba_pipe(K=960, L=8, H=64, W=96)
    lo = min(int(im.min()) for im in pipe.images.values())
    hi = max(int(im.max()) for im in pipe.images.values())
    assert len(pipe.images) == 960 and 28 <= lo and hi <= 228


def test_one_hot_equals_torch_one_hot():
    """The camera lift's one-hot, made by comparison, equals
    ``one_hot(idx, K + 1)[..., :K]`` (the dummy index K a zero row)."""
    idx = torch.as_tensor(np.random.default_rng(0).integers(0, 9, (40, 8)))
    for dtype in (torch.float32, torch.float64):
        ref = torch.nn.functional.one_hot(idx, 9)[..., :8].to(dtype)
        got = fused._one_hot(idx, 8, dtype)
        assert got.dtype == dtype and torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blocked_tree_sum_gives_the_same_build(monkeypatch, dtype):
    """With ``TREE_SUM_BLOCK_BYTES`` so small that every level of the
    camera lift is gathered a few chunks at a time, the chunk build
    (10 observations a landmark: two chunks each, as at the large size)
    is bit for bit the build that gathers each level at once."""
    problem, _, _ = synthetic.synth_ba_problem(
        "pinhole", 24, 192, 10, pixel_noise=0.5, dtype=dtype, device="cpu")
    plan = fused.plan_for_problem(problem, pow2_buckets=False)
    tree = plan.lm.seg
    assert any(multi.shape[0] > 8 for _, multi in tree.levels)
    solve = geometric_ba.make_fused_solver("pinhole")
    cfg = ba.BAConfig(huber_delta=1.0)
    cost, neq = solve.build(problem, plan, cfg)
    per_chunk = 16 * 24 * 6 * torch.finfo(dtype).bits // 8
    monkeypatch.setattr(fused, "TREE_SUM_BLOCK_BYTES", 3 * per_chunk)
    cost_b, neq_b = solve.build(problem, plan, cfg)
    assert torch.equal(cost, cost_b)
    for a, b in zip(neq, neq_b):
        assert torch.equal(a, b)
    vals = torch.as_tensor(np.random.default_rng(1).normal(
        size=(plan.lm.gidx.shape[0], 5)), dtype=dtype)
    monkeypatch.setattr(fused, "TREE_SUM_BLOCK_BYTES", 1)
    blocked = fused.tree_sum(vals, tree)
    monkeypatch.undo()
    assert torch.equal(blocked, fused.tree_sum(vals, tree))
