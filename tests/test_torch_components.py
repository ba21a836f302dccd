"""The identity the flood kernels rest on: a flood to the fixpoint is a
reduction over connected components.

An oracle that shares no code with the port labels each class's 4-connected
components with ``scipy.ndimage.label`` and reduces the seeds per component
(OR for the bundle word, min and max for the liberty flood).  It must equal
the port's plain versions, which are the kernels' specification, bit for bit;
one case per board size also goes through the JAX package.  No tolerance:
all values are integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from gymgo_tpu.core import flood as jflood
from gymgo_tpu_torch.core import flood as tflood
from torch_boards import adversarial_boards, component_boards, random_boards

_MASK9 = (1 << 9) - 1
_BUNDLE_SIZES = [1, 2, 3, 5, 9, 13, 19, 22]
_MINMAX_SIZES = _BUNDLE_SIZES + [32]
_FAMILIES = ["random", "adversarial", "components"]

_jit_bitpack = jax.jit(jflood.flood_bundle_bitpack, static_argnums=2)


def _boards(n, family):
    if family == "random":
        return random_boards(np.random.default_rng(100 + n), 8, n)
    if family == "adversarial":
        return adversarial_boards(n)
    return component_boards(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _neighbours(x, fill):
    """The four 4-neighbour planes of ``x`` (N, N), ``fill`` off the board."""
    p = np.pad(x, 1, constant_values=fill)
    return p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2], p[1:-1, 2:]


def _reduce_over_components(seed, classes, ufunc, identity):
    """Per cell of a class, ``ufunc`` over the seeds of its 4-connected
    component within that class; cells of no class keep their seed."""
    out = seed.copy()
    for cls in classes:
        labels, count = ndimage.label(cls)  # 2-D default structure: 4-connectivity
        acc = np.full(count + 1, identity, seed.dtype)
        ufunc.at(acc, labels[cls], seed[cls])
        out[cls] = acc[labels[cls]]
    return out


def oracle_bundle(a, b):
    """The bundle word of one board, (N, N) int32."""
    n = a.shape[-1]
    empty = ~(a | b)
    code = np.arange(1, n * n + 1, dtype=np.int32).reshape(n, n)
    packed = np.where(empty, code | ((~code & _MASK9) << 9), 0).astype(np.int32)
    seed = np.zeros((n, n), np.int32)
    for nb in _neighbours(packed, 0):
        seed |= nb
    seed = np.where(a | b, seed, 0)
    touch_a = np.any(_neighbours(a, False), axis=0)
    touch_b = np.any(_neighbours(b, False), axis=0)
    seed |= (empty & touch_a).astype(np.int32) << 18
    seed |= (empty & touch_b).astype(np.int32) << 19
    return _reduce_over_components(seed, (a, b, empty), np.bitwise_or, 0)


def oracle_minmax(a, b):
    """(mn, mx) of one board, (N, N) int16 each."""
    n = a.shape[-1]
    big = n * n
    empty = ~(a | b)
    idx = np.arange(big, dtype=np.int16).reshape(n, n)
    lo = np.min(_neighbours(np.where(empty, idx, big).astype(np.int16), big), axis=0)
    hi = np.max(_neighbours(np.where(empty, idx, -1).astype(np.int16), -1), axis=0)
    return (_reduce_over_components(lo, (a, b), np.minimum, big),
            _reduce_over_components(hi, (a, b), np.maximum, -1))


@pytest.mark.parametrize("family", _FAMILIES)
@pytest.mark.parametrize("n", _BUNDLE_SIZES)
def test_bundle_flood_is_an_or_over_components(n, family):
    a, b = _boards(n, family)
    want = np.stack([oracle_bundle(x, y) for x, y in zip(a, b)])
    got = tflood.bundle_flood_plain(_t(a), _t(b)).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", _FAMILIES)
@pytest.mark.parametrize("n", _MINMAX_SIZES)
def test_minmax_flood_is_a_min_and_a_max_over_components(n, family):
    a, b = _boards(n, family)
    want = [np.stack(w) for w in zip(*(oracle_minmax(x, y) for x, y in zip(a, b)))]
    got = tflood.minmax_flood_plain(_t(a), _t(b))
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype == np.int16
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("n", _BUNDLE_SIZES)
def test_bundle_oracle_matches_jax_bitpack(n):
    a, b = component_boards(n)
    word = np.stack([oracle_bundle(x, y) for x, y in zip(a, b)])
    ref = _jit_bitpack(jnp.asarray(a), jnp.asarray(b), n)
    got = tflood.unpack_bundle(_t(word), _t(a), _t(b))
    assert len(ref) == len(got)
    for j, t in zip(ref, got):
        j = np.asarray(j)
        assert j.dtype == t.numpy().dtype
        np.testing.assert_array_equal(j, t.numpy())


@pytest.mark.parametrize("n", _MINMAX_SIZES)
def test_minmax_oracle_matches_jax_two_colors(n):
    a, b = component_boards(n)
    big = n * n
    empty = ~(a | b)
    idx = np.arange(big, dtype=np.int32).reshape(n, n)
    seed_min = jflood.neighbor_min(jnp.asarray(np.where(empty, idx, big).astype(np.int32)), big)
    seed_max = jflood.neighbor_max(jnp.asarray(np.where(empty, idx, -1).astype(np.int32)), -1)
    jmn, jmx = jflood.flood_min_max_two_colors(seed_min, seed_max, jnp.asarray(a), jnp.asarray(b), big)
    want = [np.stack(w) for w in zip(*(oracle_minmax(x, y) for x, y in zip(a, b)))]
    # JAX floods in int32, the port and the oracle in int16: same values
    np.testing.assert_array_equal(np.asarray(jmn), want[0].astype(np.int32))
    np.testing.assert_array_equal(np.asarray(jmx), want[1].astype(np.int32))
