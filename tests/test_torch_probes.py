"""The port's counterparts of the two probe kernels of ``scripts/``: the
grid-overhead probe (``scripts/grid_overhead.py``) and the windowed read
at a run-time lane shift (``scripts/exp_roll.py``), their plain versions
on the CPU against numpy and, for the window read, against the Pallas
kernel run in interpret mode.  Everything here is exact: the probe's
inputs are small integers, so its checksums are exact f32 sums, and a
window is a copy.

The Pallas kernel is built here from the script's kernel body, since
importing the script runs it.  Its ``rollstatic`` mode cannot run in
interpret mode (``pltpu.roll`` refuses the negative static shift -8), so
that mode is held against numpy only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from photometric_bundle_adjustment_tpu_torch.scripts import exp_roll
from photometric_bundle_adjustment_tpu_torch.scripts import grid_overhead as go

torch.set_num_threads(1)

VARIANTS = go.variants()


@pytest.fixture(scope="module")
def probe_inputs():
    """The 7 lane inputs at the script's width and a 164-image stack of
    small (8, 16) images: the image size only scales the image sums."""
    return go.make_inputs("cpu", seed=3, hp=8, wp=16)


def test_variants_are_the_scripts():
    assert len(VARIANTS) == 11
    assert [v.n_lanes for v in VARIANTS] == [0, 0, 2, 7, 7, 7, 7, 7, 0, 0, 0]
    assert [v.code_len for v in VARIANTS[5:8]] == [go.NG, go.NG * go.GROUP,
                                                   go.NG * go.GROUP]
    assert [v.scratch for v in VARIANTS].count(True) == 1
    revisit = [len(set(v.iog)) for v in VARIANTS[8:]]
    assert revisit == [1, 40, go.NG]


@pytest.mark.parametrize("index", range(len(VARIANTS)),
                         ids=[v.label for v in VARIANTS])
def test_grid_probe_plain_version(probe_inputs, index):
    v = VARIANTS[index]
    lanes, images = probe_inputs
    args = go.variant_args(v, lanes, images)
    out, checksum = go.probe(**args)
    assert out.shape == (go.OUT_ROWS, go.NG * go.GROUP) and (out == 0).all()
    # numpy sums of the same slices, in float64: exact for these integers
    iog = np.asarray(v.iog)
    want = iog.astype(np.float64)
    for x in args["lanes"]:
        want += x.numpy().reshape(x.shape[0], go.NG, go.GROUP).sum(axis=(0, 2))
    if v.image:
        want += images.numpy()[iog].sum(axis=(1, 2))
    if v.code_len:
        want += go.GROUP + v.code_len // go.NG
    np.testing.assert_array_equal(checksum.numpy(), want)
    go.check(out, checksum, torch.as_tensor(want, dtype=torch.float32),
             v.label)


@pytest.mark.parametrize("mode", exp_roll.MODES)
def test_window_matches_numpy(mode):
    x, s = exp_roll.script_case("cpu")
    out = exp_roll.window(x, s, mode)
    assert out.shape == (1, exp_roll.ROWS, exp_roll.WIN)
    np.testing.assert_array_equal(out[0].numpy(),
                                  exp_roll.numpy_expected(x[0].numpy(), mode))


def _pallas_window(mode):
    """The script's Pallas call (``scripts/exp_roll.py:14-40``)."""

    def kernel(sref, xref, oref):
        s = sref[0]
        t = xref[:]
        if mode == "roll":
            r = pltpu.roll(t, -s, 1)
            oref[:] = r[:, :128]
        elif mode == "dynslice":
            oref[:] = xref[pl.ds(0, 24), pl.ds(s, 128)]

    return pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        ),
        out_shape=jax.ShapeDtypeStruct((24, 128), jnp.float32),
        interpret=True,
    )


@pytest.mark.parametrize("mode", ["roll", "dynslice"])
def test_window_matches_pallas(mode):
    x, s = exp_roll.script_case("cpu")
    ref = np.asarray(_pallas_window(mode)(jnp.asarray(s.numpy()),
                                          jnp.asarray(x[0].numpy())))
    np.testing.assert_array_equal(exp_roll.window(x, s, mode)[0].numpy(), ref)


@pytest.mark.parametrize("mode", exp_roll.MODES)
def test_window_batch_equals_separate_calls(mode):
    rng = np.random.default_rng(5)
    shifts = [0, 1, 13, 127, 128]
    x = torch.as_tensor(rng.normal(size=(len(shifts), 24, 256)),
                        dtype=torch.float32)
    s = torch.tensor(shifts, dtype=torch.int32)
    batch = exp_roll.window(x, s, mode)
    for b in range(len(shifts)):
        one = exp_roll.window(x[b:b + 1], s[b:b + 1], mode)
        assert torch.equal(batch[b:b + 1], one), shifts[b]
    if mode == "roll":
        # 128 and -128 read the same window; 256 + 13 reads 13's
        s2 = torch.tensor([-128, 256 + 13], dtype=torch.int32)
        assert torch.equal(exp_roll.window(x[[4, 2]], s2, mode), batch[[4, 2]])


def test_dynslice_outside_the_tile_is_nan():
    x = torch.zeros((3, 24, 256))
    s = torch.tensor([-1, 129, 128], dtype=torch.int32)
    out = exp_roll.window(x, s, "dynslice")
    assert torch.isnan(out[:2]).all() and (out[2] == 0).all()


def test_exp_roll_entry_point_on_cpu(capsys):
    assert exp_roll.main(["--device", "cpu"]) == dict.fromkeys(
        exp_roll.MODES, True)
    assert capsys.readouterr().out.splitlines() == [
        f"{m} ok: True" for m in exp_roll.MODES]
