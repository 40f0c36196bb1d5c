"""K2's plain version (``sykepic_tpu_torch.ops.flood.flood_plain``, which
:func:`~sykepic_tpu_torch.ops.flood.flood` takes for CPU tensors) against
the JAX package's two floods: ``pallas_flood.flood_pallas`` in interpret
mode and the XLA ``while_loop`` flood of ``features_device``, on the cases
of ``tests/test_pallas_flood.py`` and at small caps. Tolerance: exact
equality (bool masks). The kernel itself is held against ``flood_plain`` on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from sykepic_tpu.ops import features_device as jfd
from sykepic_tpu.ops import pallas_flood
from sykepic_tpu_torch.ingest import pack
from sykepic_tpu_torch.ops import flood


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _xla_flood(seed, within, cap):
    # the XLA formulation whatever the backend gate says
    import jax
    import jax.numpy as jnp

    within_f = jnp.asarray(within, jfd._MASK_DTYPE)
    state = jnp.asarray(seed, jfd._MASK_DTYPE) * within_f

    def cond(c):
        i, _, changed = c
        return jnp.logical_and(i < cap, changed)

    def body(c):
        i, s, _ = c
        grown = jfd._dilate3(s) * within_f
        return i + 1, grown, jnp.any(grown != s)

    _, state, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), state, jnp.bool_(True)))
    return np.asarray(state > 0.5)


def _random_case(b, h, w, p, seed):
    rng = np.random.default_rng(seed)
    within = rng.uniform(size=(b, h, w)) < p
    s = np.zeros_like(within)
    s[:, h // 2, w // 2] = True
    s[:, 0, :] = within[:, 0, :]  # border seeds like fill_holes
    return s, within


def _ring():
    h = w = 40
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.hypot(yy - 20, xx - 20)
    free = ~((r < 15) & (r > 8))[None]
    s = np.zeros_like(free)
    s[:, 0, :] = s[:, -1, :] = True
    s[:, :, 0] = s[:, :, -1] = True
    return s & free, free


def _tiles():
    rng = np.random.default_rng(7)
    within = rng.uniform(size=(5, 120, 140)) < 0.5
    s = np.zeros_like(within)
    s[:, ::17, ::23] = True
    return s, within


CASES = {
    "random_4x48x96": lambda: _random_case(4, 48, 96, 0.4, 0),
    "random_3x28x33": lambda: _random_case(3, 28, 33, 0.55, 1),
    "random_1x64x128": lambda: _random_case(1, 64, 128, 0.3, 2),
    "ring_1x40x40": _ring,
    "tiles_5x120x140": _tiles,
}


def _plain(s, within, cap):
    return flood.flood_plain(torch.from_numpy(s), torch.from_numpy(within),
                             cap, return_steps=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_flood_equals_jax_floods(name):
    s, within = CASES[name]()
    cap = s.shape[1] * s.shape[2]
    got, steps = _plain(s, within, cap)
    want = _xla_flood(s, within, cap)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        pallas_flood.flood_pallas(s, within, cap, interpret=True)))
    assert got.dtype == torch.bool and got.shape == s.shape
    assert bool((steps >= 1).all()) and int(steps.max()) < cap
    if name == "ring_1x40x40":
        assert not got[0, 20, 20]  # the hole is unreachable from the border


@pytest.mark.parametrize("cap", [1, 2, 5])
def test_plain_flood_equals_jax_floods_at_small_caps(cap):
    s, within = CASES["random_4x48x96"]()
    got, steps = _plain(s, within, cap)
    np.testing.assert_array_equal(got.numpy(), _xla_flood(s, within, cap))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        pallas_flood.flood_pallas(s, within, cap, interpret=True)))
    assert bool((steps == cap).all())  # none converges this early


def test_steps_count_up_to_the_first_step_that_changes_nothing():
    # a straight corridor of n pixels seeded at one end fills in n - 1
    # steps; the n-th step is the first that changes nothing
    n = 10
    within = torch.zeros((2, 3, n), dtype=torch.bool)
    within[0, 1, :] = True
    within[1, 1, :4] = True
    s = torch.zeros_like(within)
    s[:, 1, 0] = True
    out, steps = flood.flood_plain(s, within, 100, return_steps=True)
    assert torch.equal(out, within)
    assert steps.tolist() == [n, 4]
    out, steps = flood.flood_plain(s, within, 3, return_steps=True)
    assert steps.tolist() == [3, 3] and int(out[0].sum()) == 4
    out, steps = flood.flood_plain(s, within, 0, return_steps=True)
    assert torch.equal(out, s & within) and steps.tolist() == [0, 0]


def test_wrapper_takes_the_plain_version_on_the_cpu():
    s, within = (torch.from_numpy(a) for a in CASES["random_3x28x33"]())
    before = (flood.launches, flood.warp_launches, flood.global_launches)
    got = flood.flood(s, within, 28 * 33)
    assert (flood.launches, flood.warp_launches,
            flood.global_launches) == before
    assert torch.equal(got, flood.flood_plain(s, within, 28 * 33))
    empty = torch.zeros((0, 8, 8), dtype=torch.bool)
    assert flood.flood(empty, empty, 64).shape == (0, 8, 8)


H100_OPTIN = 232448  # bytes of shared memory a block may opt into


def test_shared_form_budget():
    # two planes of ceil(w/32) words per row: the fused path's largest
    # grid canvas side is 1024 (ingest/pack.py GRID_MAX)
    assert flood.shared_bytes(48, 96) == 2 * 48 * 3 * 4
    assert flood.shared_bytes(1, 33) == 2 * 2 * 4
    assert flood.shared_bytes(1024, 512) <= H100_OPTIN
    assert flood.shared_bytes(1024, 896) <= H100_OPTIN
    assert flood.shared_bytes(1024, 960) > H100_OPTIN
    assert flood.shared_bytes(1024, 1024) > H100_OPTIN
    assert flood.shared_bytes(1024, 1400) > H100_OPTIN


def _ladder():
    # every side the slot packer's grid can give (ingest/pack.py snap_dim)
    return sorted({pack.snap_dim(x) for x in range(1, pack.GRID_MAX + 1)})


def test_pick_form_over_every_ladder_canvas():
    sides = _ladder()
    assert sides[:3] == [8, 16, 24] and sides[-1] == 1024 and len(sides) == 28
    seen = {"warp": 0, "shared": 0, "global": 0}
    for h in sides:
        for w in sides:
            got = flood.pick_form(h, w, H100_OPTIN)
            if h <= 128 and w <= 256:
                rows = 1 if h <= 32 else 2 if h <= 64 else 4
                words = -(-w // 32)
                words = next(k for k in (1, 2, 4, 8) if words <= k)
                assert got == ("warp", rows, words), (h, w)
            elif flood.shared_bytes(h, w) <= H100_OPTIN:
                assert got == "shared", (h, w)
            else:
                assert got == "global", (h, w)
            # a canvas whose planes fit takes a one-launch form
            if flood.shared_bytes(h, w) <= H100_OPTIN:
                assert got != "global", (h, w)
            seen[got if isinstance(got, str) else got[0]] += 1
    # 12 sides up to 128 by 16 up to 256; past the budget only
    # 960x1024, 1024x960 and 1024x1024
    assert seen == {"warp": 12 * 16, "shared": 589, "global": 3}
    # the main path's canvases (chip_smoke's size mix)
    assert flood.pick_form(32, 56, H100_OPTIN) == ("warp", 1, 2)
    assert flood.pick_form(48, 96, H100_OPTIN) == ("warp", 2, 4)
    assert flood.pick_form(128, 256, H100_OPTIN) == ("warp", 4, 8)
    assert flood.pick_form(129, 256, H100_OPTIN) == "shared"
    assert flood.pick_form(128, 257, H100_OPTIN) == "shared"
    assert flood.pick_form(256, 512, H100_OPTIN) == "shared"
    assert flood.pick_form(1024, 896, H100_OPTIN) == "shared"
    assert flood.pick_form(1024, 960, H100_OPTIN) == "global"
    # a card with less shared memory sends more canvases to the global form
    assert flood.pick_form(256, 512, 16 * 1024) == "global"
    assert flood.pick_form(48, 96, 0) == ("warp", 2, 4)
