"""gymgo_tpu_torch.core.transform against gymgo_tpu.core.transform, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.core import transform as jtransform
from gymgo_tpu_torch.core import transform as ttransform
from torch_boards import midgame_states


def _states(n, seed):
    s = midgame_states(n, 24, 11 + seed, seed)  # odd and even plies: both colours to move
    s[::3, 2] = 1 - s[::3, 2]
    return s


@pytest.mark.parametrize("n", [5, 9, 19])
def test_batch_canonical_form_matches_jax(n):
    s = _states(n, n % 2)
    assert (s[:, 2, 0, 0] == 0).any() and (s[:, 2, 0, 0] == 1).any()
    want = np.asarray(jtransform.batch_canonical_form(jnp.asarray(s)))
    before = s.copy()
    got = ttransform.batch_canonical_form(torch.from_numpy(s))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(s, before)  # the input is left as it was
    # idempotent, and the single-state form is one row of the batch form
    assert torch.equal(ttransform.batch_canonical_form(got), got)
    for i in (0, 1, 5):
        np.testing.assert_array_equal(ttransform.canonical_form(torch.from_numpy(s[i])).numpy(), want[i])
        np.testing.assert_array_equal(
            np.asarray(jtransform.canonical_form(jnp.asarray(s[i]))), want[i])


@pytest.mark.parametrize("orientation", range(8))
def test_apply_symmetry_matches_jax(orientation):
    rng = np.random.default_rng(orientation)
    for shape in ((7, 7), (6, 5, 5), (3, 6, 9, 9)):
        image = rng.integers(-100, 100, shape).astype(np.int32)
        want = np.asarray(jtransform.apply_symmetry(jnp.asarray(image), orientation))
        got = ttransform.apply_symmetry(torch.from_numpy(image), orientation)
        np.testing.assert_array_equal(got.numpy(), want)
    # the turn is the same way round as jnp.rot90 over the board axes
    ramp = np.arange(9).reshape(3, 3)
    np.testing.assert_array_equal(
        ttransform.apply_symmetry(torch.from_numpy(ramp), 4).numpy(), np.rot90(ramp, axes=(-2, -1)))


def test_all_symmetries_matches_jax_and_are_distinct():
    image = np.random.default_rng(0).integers(0, 2, (6, 7, 7)).astype(np.int8)
    want = np.asarray(jtransform.all_symmetries(jnp.asarray(image)))
    got = ttransform.all_symmetries(torch.from_numpy(image)).numpy()
    assert got.shape == (8, 6, 7, 7)
    np.testing.assert_array_equal(got, want)
    assert len({x.tobytes() for x in got}) == 8


def test_random_symmetry_draws_every_orientation():
    image = torch.arange(25).reshape(5, 5)
    every = [x.numpy().tobytes() for x in ttransform.all_symmetries(image)]
    g = torch.Generator().manual_seed(0)
    seen = {every.index(ttransform.random_symmetry(g, image).numpy().tobytes()) for _ in range(200)}
    assert seen == set(range(8))
    a = ttransform.random_symmetry(torch.Generator().manual_seed(3), image)
    b = ttransform.random_symmetry(torch.Generator().manual_seed(3), image)
    assert torch.equal(a, b)
