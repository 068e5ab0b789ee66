"""The port's two-way Hamming best-two (``ops.hamming.best_two_both``) on the
CPU: its plain version against two one-way calls and against the JAX
package's XLA route, which reduces one distance matrix along both axes.

Every comparison is bit-exact: the distances are integers and the
reductions pick the lowest index among ties in every form.  The kernel
itself runs only on the card (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.features import match as jmatch
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.features import match
from photometric_bundle_adjustment_tpu_torch.ops import hamming

torch.set_num_threads(1)

CASES = ["random", "ties", "no valid rows", "one valid row",
         "non-prefix mask", "N1 != N2", "I1 != I2"]


def _case(case: str):
    """desc1 (I1, N1, 8) and desc2 (I2, N2, 8) uint32, valid1 and valid2
    bool, and a worklist a, b that holds every ordered pair."""
    rng = np.random.default_rng(CASES.index(case))
    I1, N1, I2, N2 = {"N1 != N2": (3, 70, 3, 45),
                      "I1 != I2": (4, 40, 2, 40)}.get(case, (3, 64, 3, 64))
    desc1 = rng.integers(0, 2**32, (I1, N1, 8), dtype=np.uint32)
    desc2 = rng.integers(0, 2**32, (I2, N2, 8), dtype=np.uint32)
    valid1 = np.broadcast_to(np.arange(N1) < N1 - 5, (I1, N1)).copy()
    valid2 = np.broadcast_to(np.arange(N2) < N2 - 3, (I2, N2)).copy()
    if case == "ties":
        # duplicated rows across and within the images: ties at the best
        # distance, and between best and second
        desc2[:, 10:30] = desc2[:, :20]
        desc1[:, :32] = desc2[:, rng.integers(0, N2, 32)]
        desc1[1:] = np.where(rng.random((I1 - 1, N1, 1)) < 0.5, desc1[:1],
                             desc1[1:])
        desc2[1, :20] = desc2[1, 0]
    elif case == "no valid rows":
        valid1[1] = False
        valid2[2] = False
    elif case == "one valid row":
        valid1[:] = False
        valid2[:] = False
        valid1[:, 7] = True
        valid2[:, 40] = True
    elif case in ("non-prefix mask", "N1 != N2", "I1 != I2"):
        valid1 = rng.random((I1, N1)) < 0.7
        valid2 = rng.random((I2, N2)) < 0.7
    ab = np.array([(i, j) for i in range(I1) for j in range(I2)])
    return desc1, valid1, desc2, valid2, ab[:, 0], ab[:, 1]


@functools.cache
def _xla_both():
    """The JAX package's XLA route for one pair: one Hamming matrix,
    ``_best_two_from`` along axis 1 (rows) and axis 0 (columns)."""
    def run(d1, v1, d2, v2):
        dist = jmatch.hamming_matrix(d1, d2)
        big = jmatch.BIG
        return (jmatch._best_two_from(jnp.where(v2[None, :], dist, big), 1)
                + jmatch._best_two_from(jnp.where(v1[:, None], dist, big), 0))
    return jax.jit(run)


def _torch_case(case):
    desc1, valid1, desc2, valid2, a, b = _case(case)
    return (interop.descriptors_from_numpy(desc1, "cpu"),
            torch.as_tensor(valid1),
            interop.descriptors_from_numpy(desc2, "cpu"),
            torch.as_tensor(valid2), a, b)


@pytest.mark.parametrize("case", CASES)
def test_best_two_both_matches_one_way_calls_and_xla(case):
    desc1, valid1, desc2, valid2, a, b = _case(case)
    d1, v1, d2, v2, _, _ = _torch_case(case)
    got = hamming.best_two_both_reference(d1, v1, d2, v2, a, b)
    assert [tuple(g.shape) for g in got] == [(len(a), d1.shape[1])] * 3 + [
        (len(a), d2.shape[1])] * 3
    assert all(g.dtype == torch.int32 for g in got)
    fwd = hamming.best_two_nn_reference(d1, d2, v2, a, b)
    bwd = hamming.best_two_nn_reference(d2, d1, v1, b, a)
    for g, r in zip(got, fwd + bwd):
        assert torch.equal(g, r)
    for p in range(len(a)):
        ref = _xla_both()(jnp.asarray(desc1[a[p]]), jnp.asarray(valid1[a[p]]),
                          jnp.asarray(desc2[b[p]]), jnp.asarray(valid2[b[p]]))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[p].numpy(), np.asarray(r))
    # the documented sentinels
    big = hamming.BIG
    for best, second, idx, valid in ((got[0], got[1], got[2], v2[b]),
                                     (got[3], got[4], got[5], v1[a])):
        n = valid.sum(1)
        assert bool((best[n == 0] == big).all() and (idx[n == 0] == 0).all())
        assert bool((second[n <= 1] == big).all())
        assert bool((best[n > 0] < big).all() and (second >= best).all())
    if case == "ties":
        assert bool((got[0] == got[1]).any() and (got[3] == got[4]).any())


@pytest.mark.parametrize("case", ["random", "I1 != I2"])
def test_best_two_both_on_cpu_runs_the_plain_version(case):
    """On CPU tensors the wrapper is the plain version and launches
    nothing; ``match_batch`` takes its two directions from it."""
    d1, v1, d2, v2, a, b = _torch_case(case)
    before = hamming.KERNEL_LAUNCHES
    got = hamming.best_two_both(d1, v1, d2, v2, a, b)
    ref = hamming.best_two_both_reference(d1, v1, d2, v2, a, b)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    m = match.match_batch(d1, v1, d2, v2, a, b)
    assert hamming.KERNEL_LAUNCHES == before
    m12 = match._one_way(*got[:3], v1[a], 70, 1.2)
    m21 = match._one_way(*got[3:], v2[b], 70, 1.2)
    assert torch.equal(m, match._mutual(m12, m21))


def test_best_two_both_empty_worklist():
    d1, v1, d2, v2, _, _ = _torch_case("N1 != N2")
    got = hamming.best_two_both(d1, v1, d2, v2, [], [])
    assert [tuple(g.shape) for g in got] == [(0, 70)] * 3 + [(0, 45)] * 3
