"""gymgo_tpu_torch.core.flood and the bundle-flood wrapper against the JAX package.

Inputs are made with numpy from a seed and go through both packages; every
integer and bool output must agree bit for bit.  The kernel's own tests, which
need a card, are in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.core import flood as jflood
from gymgo_tpu.ops.pallas_flood import bundle_flood_pallas
from gymgo_tpu_torch.core import flood as tflood
from gymgo_tpu_torch.ops import bundle_flood as tbundle
from torch_boards import adversarial_boards as _adversarial_boards
from torch_boards import random_boards as _random_boards

_jit_bitpack = jax.jit(jflood.flood_bundle_bitpack, static_argnums=2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_same(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("shift", [(1, 0), (-1, 0), (0, 1), (0, -1), (2, -1), (-3, 2), (0, 0)])
@pytest.mark.parametrize("dtype", [np.bool_, np.uint8, np.int32, np.int16])
def test_shift_matches_jax(shift, dtype):
    rng = np.random.default_rng(0)
    x = (rng.random((3, 7, 7)) * 50).astype(dtype)
    fill = dtype(1)
    _assert_same(jflood.shift(jnp.asarray(x), *shift, fill), tflood.shift(_t(x), *shift, fill))


@pytest.mark.parametrize("dtype", [np.bool_, np.uint8, np.int32])
def test_neighbor_or_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.random((4, 9, 9)) * 200).astype(dtype)
    _assert_same(jflood.neighbor_or(jnp.asarray(x)), tflood.neighbor_or(_t(x)))


@pytest.mark.parametrize("n", [5, 9, 19])
def test_flood_or_matches_jax(n):
    rng = np.random.default_rng(2)
    for density in (0.2, 0.5, 0.8):
        mask = rng.random((8, n, n)) < density
        seed = rng.random((8, n, n)) < 0.05
        _assert_same(jflood.flood_or(jnp.asarray(seed), jnp.asarray(mask)),
                     tflood.flood_or(_t(seed), _t(mask)))
        bits = (rng.random((8, n, n)) * 4).astype(np.uint8) * (rng.random((8, n, n)) < 0.1)
        _assert_same(jflood.flood_or(jnp.asarray(bits), jnp.asarray(mask)),
                     tflood.flood_or(_t(bits), _t(mask)))


@pytest.mark.parametrize("n", [5, 9, 19])
def test_plain_bundle_word_matches_pallas_interpret(n):
    rng = np.random.default_rng(3)
    a, b = _random_boards(rng, 12, n)
    aa, ab = _adversarial_boards(n)
    a, b = np.concatenate([a, aa]), np.concatenate([b, ab])
    pallas = bundle_flood_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    _assert_same(pallas, tflood.bundle_flood_plain(_t(a), _t(b)))
    # the wrapper takes the plain version for CPU tensors
    _assert_same(pallas, tbundle.bundle_flood(_t(a), _t(b)))


@pytest.mark.parametrize("n", [3, 5, 7, 9, 13, 19])
@pytest.mark.parametrize("boards", ["random", "adversarial"])
def test_unpacked_bundle_matches_bitpack(n, boards):
    # both kinds hold 6 boards, so the second reuses the first's compilation
    if boards == "random":
        a, b = _random_boards(np.random.default_rng(n), 6, n)
    else:
        a, b = _adversarial_boards(n)
    ref = _jit_bitpack(jnp.asarray(a), jnp.asarray(b), n)
    got = tflood.flood_bundle(_t(a), _t(b))
    assert len(ref) == len(got) == 5
    for j, t in zip(ref, got):
        _assert_same(j, t)


def test_bundle_flood_rejects_boards_over_511_cells():
    a = torch.zeros((1, 23, 23), dtype=torch.bool)
    with pytest.raises(ValueError, match="511"):
        tflood.bundle_flood_plain(a, a)
    with pytest.raises(ValueError, match="511"):
        tflood.flood_bundle(a, a)


def test_bundle_flood_cuda_rejects_cpu_tensors():
    a = torch.zeros((1, 5, 5), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        tbundle.bundle_flood_cuda(a, a)
