"""The minmax flood route of gymgo_tpu_torch against the JAX package.

The min/max liberty flood (plain version and wrapper) against the Pallas
kernel in interpret mode; its primitives, the classification and the route's
bundle outputs against the JAX functions; and a rollout of the port on the
minmax route against a JAX rollout run with ``GYMGO_FLOOD=unrolled``.  Inputs
are made with numpy from a seed; integer and bool outputs must agree bit for
bit.  The kernel's own tests, which need a card, are in test_torch_cuda.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.core import flood as jflood
from gymgo_tpu.ops.pallas_flood import minmax_liberty_flood_pallas
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import flood as tflood
from gymgo_tpu_torch.core import step as tstep
from gymgo_tpu_torch.env import batch_env as tenv
from gymgo_tpu_torch.ops import minmax_flood as tminmax
from torch_boards import adversarial_boards, random_boards

_REPO = Path(__file__).resolve().parent.parent


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_same(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    np.testing.assert_array_equal(j, t)


def _boards(n, kind):
    """Six (a, b) boards, random or adversarial, so both kinds share shapes."""
    if kind == "random":
        return random_boards(np.random.default_rng(n), 6, n)
    return adversarial_boards(n)


def _jax_seeds(a, b, n):
    """The seeds of JAX's liberty_classes_from_minmax (flood.py:364-370)."""
    big = n * n
    empty = ~(a | b)
    idx = np.arange(big, dtype=np.int32).reshape(n, n)
    seed_min = jflood.neighbor_min(jnp.asarray(np.where(empty, idx, big).astype(np.int32)), big)
    seed_max = jflood.neighbor_max(jnp.asarray(np.where(empty, idx, -1).astype(np.int32)), -1)
    return np.array(seed_min), np.array(seed_max)


@pytest.fixture
def minmax_route():
    previous = tflood.set_flood_route("unrolled")
    yield
    tflood.set_flood_route(previous)


@pytest.mark.parametrize("n", [5, 9, 19])
def test_plain_minmax_matches_pallas_interpret(n):
    a, b = random_boards(np.random.default_rng(10 + n), 12, n)
    aa, ab = adversarial_boards(n)
    a, b = np.concatenate([a, aa]), np.concatenate([b, ab])
    pm, px = minmax_liberty_flood_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    # every cell, stones and the seeds the other cells keep
    tm, tx = tflood.minmax_flood_plain(_t(a), _t(b))
    _assert_same(pm, tm)
    _assert_same(px, tx)
    # the wrapper takes the plain version for CPU tensors
    wm, wx = tminmax.minmax_flood(_t(a).to(torch.uint8), _t(b).to(torch.uint8))
    _assert_same(pm, wm)
    _assert_same(px, wx)


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_neighbor_min_max_match_jax(dtype):
    rng = np.random.default_rng(11)
    x = rng.integers(-5, 90, (4, 9, 9)).astype(dtype)
    _assert_same(jflood.neighbor_min(jnp.asarray(x), dtype(81)), tflood.neighbor_min(_t(x), 81))
    _assert_same(jflood.neighbor_max(jnp.asarray(x), dtype(-1)), tflood.neighbor_max(_t(x), -1))


@pytest.mark.parametrize("dtype", [np.bool_, np.uint8])
def test_neighbor_count_edge1_matches_jax(dtype):
    x = (np.random.default_rng(12).random((4, 7, 7)) < 0.5).astype(dtype)
    _assert_same(jflood.neighbor_count_edge1(jnp.asarray(x)), tflood.neighbor_count_edge1(_t(x)))


@pytest.mark.parametrize("n", [5, 9, 19])
@pytest.mark.parametrize("variant", ["flood_min_max_two_colors", "flood_min_max_two_colors_unrolled"])
def test_min_max_floods_match_jax_on_jax_seeds(n, variant):
    a, b = random_boards(np.random.default_rng(13 + n), 10, n)
    seed_min, seed_max = _jax_seeds(a, b, n)
    j = getattr(jflood, variant)(jnp.asarray(seed_min), jnp.asarray(seed_max), jnp.asarray(a), jnp.asarray(b), n * n)
    t = getattr(tflood, variant)(_t(seed_min), _t(seed_max), _t(a), _t(b), n * n)
    for jx, tx in zip(j, t):
        _assert_same(jx, tx)


@pytest.mark.parametrize("n", [3, 5, 7, 9, 13, 19])
@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_liberty_classes_from_minmax_match_jax(n, kind):
    a, b = _boards(n, kind)
    ref = jflood.liberty_classes_from_minmax(
        jnp.asarray(a), jnp.asarray(b), n, jflood.flood_min_max_two_colors_unrolled)
    got_fn = tflood.liberty_classes_from_minmax(
        _t(a), _t(b), n, tflood.flood_min_max_two_colors_unrolled)
    got_route = tflood.liberty_classes_from_minmax(_t(a), _t(b))  # the wrapper's flood
    for j, t1, t2 in zip(ref, got_fn, got_route):
        _assert_same(j, t1)
        _assert_same(j, t2)


@pytest.mark.parametrize("n", [5, 9, 19])
def test_liberty_classes_bitpack_matches_jax(n):
    a, b = random_boards(np.random.default_rng(14 + n), 8, n)
    ref = jflood.liberty_classes_bitpack(jnp.asarray(a), jnp.asarray(b), n)
    for j, t in zip(ref, tflood.liberty_classes_bitpack(_t(a), _t(b))):
        _assert_same(j, t)


@pytest.mark.parametrize("n", [3, 5, 7, 9, 13, 19])
@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_flood_bundle_from_parts_matches_jax_and_bundle_route(n, kind):
    a, b = _boards(n, kind)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    # JAX's flood_bundle_from_parts on its minmax route (flood.py:721-728)
    one_lib, multi_lib, atari_enc = jflood.liberty_classes_from_minmax(
        ja, jb, n, jflood.flood_min_max_two_colors_unrolled)
    empty = ~(ja | jb)
    touch = jnp.where(empty & jflood.neighbor_or(ja), jnp.uint8(1), jnp.uint8(0))
    touch = touch | jnp.where(empty & jflood.neighbor_or(jb), jnp.uint8(2), jnp.uint8(0))
    touch = jflood.flood_or_unrolled(touch, empty)
    ref = (one_lib, multi_lib, empty & (touch == 1), empty & (touch == 2), atari_enc)
    got = tflood.flood_bundle_from_parts(_t(a), _t(b))
    bundle = tflood.flood_bundle(_t(a), _t(b))
    assert len(got) == len(bundle) == 5
    for j, t, u in zip(ref, got, bundle):
        _assert_same(j, t)
        assert torch.equal(t, u)


def test_minmax_flood_cuda_rejects_cpu_tensors():
    a = torch.zeros((1, 5, 5), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        tminmax.minmax_flood_cuda(a, a)


@pytest.mark.parametrize("name", ["bitpack", "gatepack", "pallas", "unrolled", "simple", "split", "sweep", "hybrid"])
def test_set_flood_route_follows_the_jax_mapping(name):
    previous = tflood.set_flood_route(name)
    try:
        bundle = name in ("bitpack", "gatepack", "pallas")
        assert tflood.flood_route == name
        assert tflood.flood_bundle_best is (tflood.flood_bundle if bundle else tflood.flood_bundle_from_parts)
        assert tflood.liberty_classification_best is (
            tflood.liberty_classes_bitpack if bundle else tflood.liberty_classes_from_minmax)
        assert tflood.flood_or_best is tflood.flood_or
    finally:
        assert tflood.set_flood_route(previous) == name


_JAX_ROLLOUT = """
import functools, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from gymgo_tpu.config import EnvConfig
from gymgo_tpu.core import flood, step
from gymgo_tpu.env import batch_env
assert step.flood_bundle is flood.flood_bundle_from_parts, "not the minmax route"
n, b, steps, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
cfg = EnvConfig(board_size=n, batch_size=b, reward_method="heuristic", auto_reset=True)
fn = jax.jit(functools.partial(batch_env.rollout, config=cfg), static_argnums=(2,))
r = fn(jax.random.PRNGKey(0), jnp.zeros((b, 6, n, n), jnp.int8), steps)
np.savez(out, actions=np.asarray(r.actions), rewards=np.asarray(r.rewards),
         dones=np.asarray(r.dones), final_states=np.asarray(r.final_states))
"""


def test_minmax_route_rollout_matches_jax_unrolled(tmp_path, minmax_route):
    n, b, steps = 9, 64, 120
    out = tmp_path / "jax_unrolled.npz"
    env = dict(os.environ, GYMGO_FLOOD="unrolled", JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", _JAX_ROLLOUT, str(n), str(b), str(steps), str(out)],
                   cwd=_REPO, env=env, check=True, capture_output=True)
    ref = np.load(out)
    assert ref["dones"].any(), "the window should end and auto-reset some games"
    cfg = EnvConfig(board_size=n, batch_size=b, reward_method="heuristic", auto_reset=True)
    acts = iter(torch.from_numpy(ref["actions"]))
    t = tenv.rollout(torch.Generator().manual_seed(0), torch.zeros((b, 6, n, n), dtype=torch.int8),
                     steps, cfg, policy_fn=lambda _g, _s: next(acts))
    for field in ("actions", "rewards", "dones", "final_states"):
        np.testing.assert_array_equal(ref[field], getattr(t, field).numpy(), err_msg=field)
    assert not t.invalid.any()


def test_stateless_step_planes_agree_between_routes():
    n, b = 9, 48
    cfg = EnvConfig(board_size=n, batch_size=b, reward_method="heuristic", auto_reset=True)
    states = tenv.rollout(torch.Generator().manual_seed(1), torch.zeros((b, 6, n, n), dtype=torch.int8),
                          70, cfg).final_states
    ps = tstep.planes_from_states(states)  # atari=None: the stateless capture path
    rng = np.random.default_rng(15)
    for _ in range(3):
        acts = torch.from_numpy(rng.integers(0, n * n + 1, b).astype(np.int32))
        outs = {}
        for route in ("bitpack", "unrolled"):
            previous = tflood.set_flood_route(route)
            try:
                outs[route] = tstep.step_planes(ps, acts)
            finally:
                tflood.set_flood_route(previous)
        (ps_a, info_a), (ps_b, info_b) = outs["bitpack"], outs["unrolled"]
        assert ps_a.atari is None and ps_b.atari is None
        for x, y in zip(tuple(ps_a) + tuple(info_a), tuple(ps_b) + tuple(info_b)):
            assert (x is None and y is None) or torch.equal(x, y)
        ps = ps_a
