"""The claim flood of gymgo_tpu_torch against the JAX package.

The claim flood's plain version (``core.flood.claim_flood_plain``, the
specification of the hand kernel in ``csrc/claim_flood.cu``) against JAX's
``flood_or_unrolled`` on the touch word JAX's minmax route builds, and against
a component labelling by scipy; the minmax route's bundle outputs, the area
score and a 25x25 minmax-route rollout against the JAX package at the board
sizes the bundle word cannot hold; and the board sizes at which the compiled
forms capture.  Inputs are made with numpy from a seed; every output is an
integer or a bool, so they must agree bit for bit.  The kernel's own tests,
which need a card, are in test_torch_cuda.py.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from gymgo_tpu.core import flood as jflood
from gymgo_tpu.core import score as jscore
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import flood as tflood
from gymgo_tpu_torch.core import score as tscore
from gymgo_tpu_torch.env import batch_env as tenv
from gymgo_tpu_torch.ops import claim_flood as tclaim
from gymgo_tpu_torch.utils import graphs
from test_torch_minmax import _JAX_ROLLOUT
from torch_boards import adversarial_boards, component_boards, random_boards, states_on_boards

_REPO = Path(__file__).resolve().parent.parent
_SIZES = [1, 2, 5, 9, 19, 23, 25, 32]
_FAMILIES = ["random", "adversarial", "components"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _boards(n, family):
    if family == "random":
        return random_boards(np.random.default_rng(200 + n), 8, n)
    if family == "adversarial":
        return adversarial_boards(n)
    return component_boards(n)


@jax.jit
def _jax_claims(a, b):
    """JAX's claim flood: the touch word of flood_bundle_from_parts
    (gymgo_tpu/core/flood.py:723-724) through flood_or_unrolled."""
    empty = ~(a | b)
    touch = jnp.where(empty & jflood.neighbor_or(a), jnp.uint8(1), jnp.uint8(0))
    touch = touch | jnp.where(empty & jflood.neighbor_or(b), jnp.uint8(2), jnp.uint8(0))
    return jflood.flood_or_unrolled(touch, empty)


@functools.partial(jax.jit, static_argnums=2)
def _jax_classes(a, b, n):
    """JAX's minmax route's liberty classification."""
    return jflood.liberty_classes_from_minmax(a, b, n, jflood.flood_min_max_two_colors_unrolled)


def _oracle_claims(a, b):
    """Per empty cell the OR of its empty region's touch bits, 0 on stones,
    by scipy's labelling of the empty cells (4-connectivity)."""
    empty = ~(a | b)
    pa, pb = np.pad(a, 1), np.pad(b, 1)
    touch_a = pa[:-2, 1:-1] | pa[2:, 1:-1] | pa[1:-1, :-2] | pa[1:-1, 2:]
    touch_b = pb[:-2, 1:-1] | pb[2:, 1:-1] | pb[1:-1, :-2] | pb[1:-1, 2:]
    seed = np.where(empty, touch_a.astype(np.uint8) | (touch_b.astype(np.uint8) << 1), 0).astype(np.uint8)
    labels, count = ndimage.label(empty)
    acc = np.zeros(count + 1, np.uint8)
    np.bitwise_or.at(acc, labels[empty], seed[empty])
    out = np.zeros_like(seed)
    out[empty] = acc[labels[empty]]
    return out


@pytest.mark.parametrize("kind", ["random", "adversarial"])
@pytest.mark.parametrize("n", _SIZES)
def test_plain_claim_flood_matches_jax_flood_or_unrolled(n, kind):
    a, b = _boards(n, kind)
    want = np.asarray(_jax_claims(jnp.asarray(a), jnp.asarray(b)))
    got = tflood.claim_flood_plain(_t(a), _t(b))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(want, got.numpy())
    # the wrapper takes the plain version for CPU tensors, bool or uint8
    assert torch.equal(tclaim.claim_flood(_t(a).to(torch.uint8), _t(b).to(torch.uint8)), got)


@pytest.mark.parametrize("family", _FAMILIES)
@pytest.mark.parametrize("n", _SIZES)
def test_claim_flood_is_an_or_over_empty_regions(n, family):
    a, b = _boards(n, family)
    want = np.stack([_oracle_claims(x, y) for x, y in zip(a, b)])
    np.testing.assert_array_equal(tflood.claim_flood_plain(_t(a), _t(b)).numpy(), want)


def test_claim_flood_cuda_rejects_cpu_tensors():
    a = torch.zeros((1, 25, 25), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        tclaim.claim_flood_cuda(a, a)


@pytest.mark.parametrize("n", [23, 25, 32])
@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_flood_bundle_from_parts_matches_jax_over_22x22(n, kind):
    a = _boards(n, kind)
    ja, jb = jnp.asarray(a[0]), jnp.asarray(a[1])
    # JAX's flood_bundle_from_parts on its minmax route (flood.py:719-728)
    one_lib, multi_lib, atari_enc = _jax_classes(ja, jb, n)
    touch = _jax_claims(ja, jb)
    empty = ~(ja | jb)
    ref = (one_lib, multi_lib, empty & (touch == 1), empty & (touch == 2), atari_enc)
    got = tflood.flood_bundle_from_parts(_t(a[0]), _t(a[1]))
    assert len(got) == 5
    for j, t in zip(ref, got):
        j = np.asarray(j)
        assert j.dtype == t.numpy().dtype
        np.testing.assert_array_equal(j, t.numpy())


@pytest.mark.parametrize("n", [23, 25, 32])
def test_areas_over_22x22_match_jax(n):
    states = states_on_boards(n, 30 + n)
    want = jax.jit(jscore.areas)(jnp.asarray(states))
    got = tscore.areas(_t(states))
    for j, t in zip(want, got):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    np.testing.assert_array_equal(np.asarray(jax.jit(jscore.winning)(jnp.asarray(states), 0.5)),
                                  tscore.winning(_t(states), 0.5).numpy())


def test_25x25_minmax_route_rollout_matches_jax_unrolled(tmp_path):
    n, b, steps = 25, 8, 200
    out = tmp_path / "jax_unrolled_25.npz"
    env = dict(os.environ, GYMGO_FLOOD="unrolled", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", _JAX_ROLLOUT, str(n), str(b), str(steps), str(out)],
                   cwd=_REPO, env=env, check=True, capture_output=True)
    ref = np.load(out)
    assert (ref["rewards"] != 0).any(), "the heuristic reward reads the claimed areas every step"
    cfg = EnvConfig(board_size=n, batch_size=b, reward_method="heuristic", auto_reset=True)
    acts = iter(torch.from_numpy(ref["actions"]))
    previous = tflood.set_flood_route("unrolled")
    try:
        t = tenv.rollout(torch.Generator().manual_seed(0), torch.zeros((b, 6, n, n), dtype=torch.int8),
                         steps, cfg, policy_fn=lambda _g, _s: next(acts))
    finally:
        tflood.set_flood_route(previous)
    for field in ("actions", "rewards", "dones", "final_states"):
        np.testing.assert_array_equal(ref[field], getattr(t, field).numpy(), err_msg=field)
    assert not t.invalid.any()


@pytest.mark.parametrize("route,n,want", [
    ("bitpack", 9, True), ("bitpack", 19, True), ("bitpack", 22, True), ("bitpack", 23, False),
    ("pallas", 22, True), ("pallas", 25, False),
    ("unrolled", 1, True), ("unrolled", 9, True), ("unrolled", 19, True), ("unrolled", 23, True),
    ("unrolled", 25, True), ("unrolled", 32, True), ("unrolled", 33, True), ("unrolled", 64, True),
    ("unrolled", 181, True), ("unrolled", 182, False), ("simple", 32, True),
])
def test_capturable_follows_the_routes_kernels(route, n, want):
    previous = tflood.set_flood_route(route)
    try:
        assert graphs.capturable(n) is want
        assert graphs.capturable_states({"states": torch.zeros((1, 6, n, n), dtype=torch.int8)}) is want
    finally:
        tflood.set_flood_route(previous)
