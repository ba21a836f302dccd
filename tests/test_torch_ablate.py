"""The step's cost-decomposition switches against the JAX package's, bit for bit.

``GYMGO_ABLATE`` (``gymgo_tpu_torch.core.step.set_ablate`` against
``gymgo_tpu.core.step._ABLATE``) and ``GYMGO_BITPACK_FIXED_ONLY`` with
``GYMGO_BITPACK_PREFIX`` (``core.flood.set_bitpack_fixed_only`` against
``gymgo_tpu.core.flood._BITPACK_FIXED_ONLY`` / ``_BITPACK_PREFIX``).  An ablated
step is wrong by design, but deterministic: the port's must equal JAX's on
every field, through ``step_states`` and ``step_planes`` with and without the
carried planes.  The JAX package reads its switches while it traces, so its
globals are patched with ``monkeypatch`` between two ``jax.clear_caches()``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymgo_tpu.config import EnvConfig as JEnvConfig
from gymgo_tpu.core import flood as jflood
from gymgo_tpu.core import step as jstep
from gymgo_tpu.env import batch_env as jbatch_env
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import flood as tflood
from gymgo_tpu_torch.core import step as tstep
from gymgo_tpu_torch.env.batch_env import rollout
from test_torch_step import _assert_tuple_equal, _random_actions
from torch_boards import midgame_states, states_on_boards

STEP_TOKENS = ("hit", "ko", "capsum", "bundle", "areas", "invd")
CASES = [(t,) for t in STEP_TOKENS] + [STEP_TOKENS]
SIZES = [(5, 24, 40), (9, 16, 24), (19, 8, 12)]  # (N, B, steps)


@contextlib.contextmanager
def _ablated(monkeypatch, tokens):
    """Both packages' steps with ``tokens`` ablated; JAX's traces dropped on
    the way in and out, so no trace outlives the patch."""
    jax.clear_caches()
    monkeypatch.setattr(jstep, "_ABLATE", frozenset(tokens))
    previous = tstep.set_ablate(tokens)
    try:
        yield
    finally:
        tstep.set_ablate(previous)
        monkeypatch.undo()
        jax.clear_caches()


class _CountingFlood:
    """Stands in for ``core.flood.flood_bundle_best`` and counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def _start_states(n, b):
    return midgame_states(n, b, n * n // 3, n)


def _seeded(states):
    """The port's planes with their carried planes seeded, and the same in
    JAX arrays (the seeds are held against JAX's in ``test_torch_step``; no
    switch here touches them, and seeding in JAX would cost a compilation)."""
    tps = tstep.planes_from_states(torch.from_numpy(states.copy()))
    tps = tps._replace(atari=tstep.init_atari(tps), ko_surr=tstep.init_ko_surr(tps))
    return tps, jstep.PlanesState(*(jnp.asarray(x.numpy()) for x in tps))


def _seed_jax(ps):
    return ps._replace(atari=jstep.init_atari(ps), ko_surr=jstep.init_ko_surr(ps))


def _jax_step_pair(states, ps, actions):
    """JAX's stateless step and carried step, compiled together."""
    return jstep.step_states(states, actions), jstep.step_planes(ps, actions)


def _compiled_step_pair(states, ps, actions):
    """``_jax_step_pair`` compiled for these shapes at XLA's optimisation
    level 0: the step is integer and boolean arithmetic, so the level sets
    the compile time (a quarter of the default's here), not the result."""
    return jax.jit(_jax_step_pair).lower(jnp.asarray(states), ps, jnp.asarray(actions)).compile(
        compiler_options={"xla_backend_optimization_level": 0})


@pytest.mark.parametrize("n,b,steps", SIZES)
@pytest.mark.parametrize("tokens", CASES, ids=lambda t: "+".join(t))
def test_ablated_step_matches_jax(tokens, n, b, steps, monkeypatch):
    rng = np.random.default_rng(n)
    states = _start_states(n, b)
    differs, wholes = False, 0
    tps, jps = _seeded(states)
    with _ablated(monkeypatch, tokens):
        counter = _CountingFlood(tflood.flood_bundle_best)
        monkeypatch.setattr(tflood, "flood_bundle_best", counter)
        for step in range(steps):
            acts = _random_actions(rng, states)
            if step == 0:
                jax_steps = _compiled_step_pair(states, jps, acts)
            (jnew, jinfo), (jps, jpinfo) = jax_steps(jnp.asarray(states), jps, jnp.asarray(acts))
            tnew, tinfo = tstep.step_states(torch.from_numpy(states.copy()), torch.from_numpy(acts))
            np.testing.assert_array_equal(np.asarray(jnew), tnew.numpy())
            _assert_tuple_equal(jinfo, tinfo)
            # step_planes without the carried planes: JAX's step_states is that step
            uncarried, uinfo = tstep.step_planes(tstep.planes_from_states(torch.from_numpy(states.copy())),
                                                 torch.from_numpy(acts))
            assert uncarried.atari is None and uncarried.ko_surr is None
            np.testing.assert_array_equal(np.asarray(jnew), tstep.states_from_planes(uncarried).numpy())
            _assert_tuple_equal(jinfo, uinfo)
            # with the carried planes, on their own trajectory of the same actions
            tps, tpinfo = tstep.step_planes(tps, torch.from_numpy(acts))
            _assert_tuple_equal(jps, tps)
            _assert_tuple_equal(jpinfo, tpinfo)
            # the switch acted: the whole step differs somewhere
            if not differs:
                previous = tstep.set_ablate(())
                try:
                    whole, winfo = tstep.step_states(torch.from_numpy(states.copy()), torch.from_numpy(acts))
                finally:
                    tstep.set_ablate(previous)
                wholes += 1
                differs = not (torch.equal(whole, tnew) and all(torch.equal(x, y) for x, y in zip(winfo, tinfo)))
            states = np.asarray(jnew)
        # three ablated steps a move, and the whole steps: no post-move flood under "bundle"
        assert counter.calls == wholes + (0 if "bundle" in tokens else 3 * steps)
    assert differs or tokens == ("ko",)


def test_ko_ablation_takes_the_ko_point_out(monkeypatch):
    """The scripted ko of ``test_torch_step``: white's retake at once is
    invalid on the whole step and allowed under ``ko``, in both packages."""
    from test_torch_step import _scripted_ko_game

    states, moves = _scripted_ko_game()
    with _ablated(monkeypatch, ("ko",)):
        jit_states = jax.jit(jstep.step_states)
        flagged = []
        for acts in moves:
            jnew, jinfo = jit_states(jnp.asarray(states), jnp.asarray(acts))
            tnew, tinfo = tstep.step_states(torch.from_numpy(states.copy()), torch.from_numpy(acts))
            np.testing.assert_array_equal(np.asarray(jnew), tnew.numpy())
            _assert_tuple_equal(jinfo, tinfo)
            flagged.append(bool(tinfo.invalid_action[0]))
            states = np.asarray(jnew)
    assert not flagged[9]


@pytest.mark.parametrize("tokens", CASES + [()], ids=lambda t: "+".join(t) or "whole")
def test_minmax_route_equals_bundle_route_under_ablation(tokens):
    n, b, steps = 9, 16, 16
    rng = np.random.default_rng(3)
    states = _start_states(n, b)
    previous = tstep.set_ablate(tokens)
    try:
        tps = tstep.planes_from_states(torch.from_numpy(states.copy()))
        tps = tps._replace(atari=tstep.init_atari(tps), ko_surr=tstep.init_ko_surr(tps))
        for _ in range(steps):
            acts = torch.from_numpy(_random_actions(rng, states))
            outs = {}
            for route in ("bitpack", "unrolled"):
                before = tflood.set_flood_route(route)
                try:
                    outs[route] = (tstep.step_states(torch.from_numpy(states.copy()), acts),
                                   tstep.step_planes(tps, acts))
                finally:
                    tflood.set_flood_route(before)
            (sb, ib), (pb, pib) = outs["bitpack"]
            (sm, im), (pm, pim) = outs["unrolled"]
            assert torch.equal(sb, sm)
            for x, y in zip((*ib, *pb, *pib), (*im, *pm, *pim)):
                assert torch.equal(x, y)
            states, tps = sb.numpy(), pb
    finally:
        tstep.set_ablate(previous)


def test_set_ablate_restores_and_rejects_unknown_tokens():
    start = tstep.ablate
    previous = tstep.set_ablate(["bundle", "areas"])
    assert previous == start
    assert tstep.set_ablate(("invd",)) == frozenset({"bundle", "areas"})
    with pytest.raises(ValueError, match="unknown GYMGO_ABLATE"):
        tstep.set_ablate(("flood",))
    assert tstep.ablate == frozenset({"invd"})
    tstep.set_ablate(start)
    assert tstep.ablate == start


def test_sampler_ablation_rollout_matches_jax(monkeypatch):
    """``sampler``: every action 0, so the two packages' auto-reset rollouts
    are one deterministic stream, held bit for bit."""
    n, b, steps = 5, 8, 12
    states = _start_states(n, b)
    cfg = EnvConfig(board_size=n, batch_size=b, reward_method="heuristic", auto_reset=True)
    jcfg = JEnvConfig(board_size=n, batch_size=b, reward_method="heuristic", auto_reset=True)
    with _ablated(monkeypatch, ("sampler",)):
        jr = jax.jit(lambda k, s: jbatch_env.rollout(k, s, steps, jcfg))(jax.random.PRNGKey(0), jnp.asarray(states))
        g = torch.Generator().manual_seed(0)
        tr = rollout(g, torch.from_numpy(states.copy()), steps, cfg)
        assert torch.equal(g.get_state(), torch.Generator().manual_seed(0).get_state())  # nothing drawn
    assert (tr.actions == 0).all()
    for field in ("actions", "rewards", "dones", "final_states"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, field)), getattr(tr, field).numpy(), err_msg=field)


def _fixed_only(monkeypatch, prefix):
    jax.clear_caches()
    monkeypatch.setattr(jflood, "_BITPACK_FIXED_ONLY", True)
    monkeypatch.setattr(jflood, "_BITPACK_PREFIX", prefix)
    return tflood.set_bitpack_fixed_only(prefix)


@pytest.mark.parametrize("prefix", [0, 2, 16])
@pytest.mark.parametrize("n", [5, 19])
def test_fixed_only_flood_matches_jax(prefix, n, monkeypatch):
    states = states_on_boards(n, 5)
    a, b = states[:, 0] != 0, states[:, 1] != 0
    whole = tflood.flood_bundle(torch.from_numpy(a), torch.from_numpy(b))
    previous = _fixed_only(monkeypatch, prefix)
    try:
        jout = jax.jit(jflood.flood_bundle_bitpack, static_argnums=2)(jnp.asarray(a), jnp.asarray(b), n)
        tout = tflood.flood_bundle(torch.from_numpy(a), torch.from_numpy(b))
    finally:
        tflood.set_bitpack_fixed_only(previous)
        monkeypatch.undo()
        jax.clear_caches()
    for j, t in zip(jout, tout):
        assert np.asarray(j).dtype == t.numpy().dtype
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    truncated = any(not torch.equal(x, y) for x, y in zip(whole, tout))
    assert truncated == (prefix < 16)  # 8 rounds converge every one of these boards


def test_fixed_only_step_matches_jax(monkeypatch):
    n, b, steps, prefix = 9, 16, 12, 2
    rng = np.random.default_rng(4)
    states = _start_states(n, b)
    previous = _fixed_only(monkeypatch, prefix)
    try:
        # the truncated flood seeds the carried atari plane in both packages
        jps = jax.jit(lambda s: _seed_jax(jstep.planes_from_states(s)))(jnp.asarray(states))
        tps = tstep.planes_from_states(torch.from_numpy(states.copy()))
        tps = tps._replace(atari=tstep.init_atari(tps), ko_surr=tstep.init_ko_surr(tps))
        _assert_tuple_equal(jps, tps)
        for step in range(steps):
            acts = _random_actions(rng, states)
            if step == 0:
                jax_steps = _compiled_step_pair(states, jps, acts)
            (jnew, jinfo), (jps, jpinfo) = jax_steps(jnp.asarray(states), jps, jnp.asarray(acts))
            tnew, tinfo = tstep.step_states(torch.from_numpy(states.copy()), torch.from_numpy(acts))
            np.testing.assert_array_equal(np.asarray(jnew), tnew.numpy())
            _assert_tuple_equal(jinfo, tinfo)
            tps, tpinfo = tstep.step_planes(tps, torch.from_numpy(acts))
            _assert_tuple_equal(jps, tps)
            _assert_tuple_equal(jpinfo, tpinfo)
            states = np.asarray(jnew)
    finally:
        tflood.set_bitpack_fixed_only(previous)
        monkeypatch.undo()
        jax.clear_caches()


def test_set_bitpack_fixed_only_restores_and_checks_its_prefix():
    start = tflood.fixed_only_prefix
    assert tflood.set_bitpack_fixed_only(4) == start
    assert tflood.set_bitpack_fixed_only(None) == 4
    for bad in (-2, 2.0, True):
        with pytest.raises(ValueError):
            tflood.set_bitpack_fixed_only(bad)
    assert tflood.fixed_only_prefix is None
    tflood.set_bitpack_fixed_only(start)


def test_fixed_only_round_is_forward_then_reverse():
    """A truncated word equals JAX's only if the directions come in JAX's
    order: one round is a forward substep, then a reverse one, and the order
    shows in the word."""
    states = states_on_boards(9, 7)
    a, b = torch.from_numpy(states[:, 0] != 0), torch.from_numpy(states[:, 1] != 0)
    seed, gates = tflood.bundle_seed_and_gates(a, b)
    fwd = tflood.bundle_substep(seed, gates)
    previous = tflood.set_bitpack_fixed_only(2)
    try:
        word = tflood.bundle_flood_plain(a, b)
    finally:
        tflood.set_bitpack_fixed_only(previous)
    assert torch.equal(word, tflood.bundle_substep(fwd, gates, reverse=True))
    assert not torch.equal(word, tflood.bundle_substep(fwd, gates))
