"""The port's counterparts of the two probe kernels of ``scripts/``: the
grid-overhead probe (``scripts/grid_overhead.py``) and the windowed read
at a run-time lane shift (``scripts/exp_roll.py``), their plain versions
on the CPU against numpy and, for the window read, against the Pallas
kernel run in interpret mode; the grid probe kernel's work plan and its
numpy emulation against the plain version.  Everything here is exact: the
probe's inputs are small integers, so its checksums are exact f32 sums,
and a window is a copy.

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


# (ng, iog, lane inputs, image stack (kimg, H, W) or None, code entries per
# step, SMs): irregular image indices, a grid smaller than the units, H*W
# not a multiple of the slice (130 * 128 = 16,640 floats: two slices)
PLAN_CASES = {
    "repeats-ng7": (7, [5, 0, 5, 2, 0, 6, 5], 7, (8, 130, 128), 3, 132),
    "repeats-ng7-3sm": (7, [5, 0, 5, 2, 0, 6, 5], 7, (8, 130, 128), 3, 3),
    "runs-ng160": (160, [g * 40 // 160 for g in range(160)], 7, (164, 8, 16),
                   256, 132),
    "constant-ng160-no-lanes": (160, [3] * 160, 0, (164, 130, 128), 0, 132),
    "distinct-ng160": (160, [(7 * g) % 164 for g in range(160)], 2,
                       (164, 130, 128), 0, 132),
    "no-image-ng7": (7, [1, 1, 0, 4, 2, 2, 9], 2, None, 1, 5),
    "nothing-ng7": (7, [0, 3, 3, 3, 1, 0, 2], 0, None, 0, 132),
}


def _plan_case(name):
    """The case's plan, numpy inputs for ``emulate`` and ``probe`` args."""
    ng, iog, n_lanes, shape, per_step, n_sm = PLAN_CASES[name]
    rng = np.random.default_rng(11)

    def ints(*s, hi=4):
        return rng.integers(0, hi, s).astype(np.float32)

    lanes = [ints(r, ng * go.GROUP) for r in go.LANE_ROWS[:n_lanes]]
    images = None if shape is None else ints(*shape)
    cnt = code = None
    if per_step:
        cnt = rng.integers(0, 300, ng).astype(np.int32)
        code = rng.integers(0, 5, ng * per_step).astype(np.int32)
    iog = np.asarray(iog, np.int32)
    p = go.plan(ng, tuple(x.shape[0] for x in lanes),
                0 if images is None else shape[0],
                0 if images is None else shape[1] * shape[2], n_sm,
                0 if code is None else code.size)

    def t(a):
        return None if a is None else torch.as_tensor(a)

    args = dict(lanes=[t(x) for x in lanes], iog=t(iog), images=t(images),
                cnt=t(cnt), code=t(code))
    return p, (lanes, iog, images, cnt, code), args


@pytest.mark.parametrize("name", PLAN_CASES)
def test_plan_covers_each_element_once(name):
    p, (lanes, iog, images, cnt, code), _ = _plan_case(name)
    assert p.n_out % p.grid == 0 and p.out_tile4 <= go.UNIT4
    assert p.chunk_rows * go.GROUP // 4 <= go.UNIT4
    assert p.slice_elems <= 4 * go.UNIT4 and p.slice_elems % 4 == 0
    _, _, reads = go.emulate(p, lanes, iog, images, cnt, code)
    assert (reads["out"] == 1).all()
    for r in reads["lanes"]:
        assert (r == 1).all()
    if code is not None:
        assert (reads["code"] == 1).all()
    if images is not None:
        used = np.zeros(images.shape[0], bool)
        used[iog] = True
        img = reads["images"]
        assert (img[used] == 1).all() and (img[~used] == 0).all()
        # slots: every step's lane units, then each distinct image's slices
        assert p.n_slots >= p.img_slot0 + used.sum() * p.n_slices


@pytest.mark.parametrize("name", PLAN_CASES)
def test_emulation_matches_plain_version(name):
    p, np_args, args = _plan_case(name)
    out, checksum, _ = go.emulate(p, *np_args)
    ref_out, ref = go.probe_reference(**args)
    np.testing.assert_array_equal(out, ref_out.numpy())
    np.testing.assert_array_equal(checksum, ref.numpy())


@pytest.mark.parametrize("index", range(len(VARIANTS)),
                         ids=[v.label for v in VARIANTS])
def test_emulation_matches_variants(probe_inputs, index):
    v = VARIANTS[index]
    lanes, images = probe_inputs
    args = go.variant_args(v, lanes, images)
    p = go.plan(go.NG, tuple(x.shape[0] for x in args["lanes"]),
                images.shape[0], images[0].numel() if v.image else 0, 132,
                v.code_len)

    def a(key):
        return None if args.get(key) is None else args[key].numpy()

    out, checksum, _ = go.emulate(p, [x.numpy() for x in args["lanes"]],
                                  np.asarray(v.iog), a("images"), a("cnt"),
                                  a("code"))
    _, ref = go.probe_reference(**args)
    assert (out == 0).all()
    np.testing.assert_array_equal(checksum, ref.numpy())


def test_emulation_marks_an_index_outside_the_stack():
    # the kernel reads no image for it and gives that step a NaN checksum
    p, (lanes, iog, images, cnt, code), _ = _plan_case("repeats-ng7")
    iog = iog.copy()
    iog[3] = images.shape[0]
    _, checksum, reads = go.emulate(p, lanes, iog, images, cnt, code)
    assert np.isnan(checksum[3]) and np.isfinite(np.delete(checksum, 3)).all()
    assert reads["images"].max() == 1


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        go.plan(7, (), go.MAX_IMAGES + 1, 16, 132)
    with pytest.raises(ValueError):
        go.plan(7, (), 4, 18, 132)
    with pytest.raises(ValueError):
        go.plan(7, (), 0, 0, 132, code_len=8)


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
