"""The carried step's one launch (``ops.env_step.fused``, ``env_fused_launch``
in ``csrc/env_step.cu``) without a card: a numpy emulation of the kernel
stands in for the launch, reading its arguments' ctypes struct and the
tensors at its pointers, with the bundle word from the plain flood.  The
rollout and ``step_planes`` on carried planes then run the package's own
orchestration (the dispatch, the struct, its pointers and strides, the
window's rows) on CPU tensors against the op-by-op ``step_planes_plain``.
The kernel itself runs on the card (``tests/test_torch_cuda_env_step.py``).
"""

import collections
import contextlib
import ctypes
import re

import numpy as np
import pytest
import torch

from gymgo_tpu_torch.config import HEURISTIC, REAL, EnvConfig
from gymgo_tpu_torch.core import flood as tflood
from gymgo_tpu_torch.core import step as tstep
from gymgo_tpu_torch.core.actions import uniform_random_actions
from gymgo_tpu_torch.core.state import batch_init_state
from gymgo_tpu_torch.env.batch_env import rollout
from gymgo_tpu_torch.ops import env_step
from torch_boards import crafted_state

_NO_KO = (1 << 9) - 1


def _at(ptr, ctype, count):
    """The ``count`` values of ``ctype`` at address ``ptr``, as a numpy view."""
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


def _planes(ptr, stride, b, m, ctype=ctypes.c_uint8):
    """Board planes of ``m`` cells, board ``i``'s at ``ptr + i * stride``
    values: a ``(b, m)`` view."""
    flat = _at(ptr, ctype, (b - 1) * stride + m)
    return np.lib.stride_tricks.as_strided(flat, (b, m), (stride * flat.itemsize, flat.itemsize))


def _neighbours_or(x, n):
    """The OR of each cell's 4 neighbours, 0 off the board: ``(b, m)``."""
    g = np.pad(x.reshape(-1, n, n), ((0, 0), (1, 1), (1, 1)))
    return (g[:, :-2, 1:-1] | g[:, 2:, 1:-1] | g[:, 1:-1, :-2] | g[:, 1:-1, 2:]).reshape(x.shape)


def _emulate_fused(a):
    """``env_fused_launch`` on CPU memory: the kernel's steps, board by
    board in numpy, from the struct ``a`` (``env_step._FusedArgs``)."""
    b, n = a.batch, a.n
    m = n * n
    cells = np.arange(m)
    rows = np.arange(b)
    flag = lambda ptr: _planes(ptr, a.flag_stride, b, 1)[:, 0] != 0  # noqa: E731
    fresh = (a.reset != 0) & flag(a.done)
    keep = ~fresh[:, None]
    black = (_planes(a.black, a.plane_stride, b, m) != 0) & keep
    white = (_planes(a.white, a.plane_stride, b, m) != 0) & keep
    invd = (_planes(a.invd, a.plane_stride, b, m) != 0) & keep
    atari = np.where(keep, _planes(a.atari, m, b, m, ctypes.c_int16), 0).astype(np.int64)
    wtm, passed, done = (flag(p) & ~fresh for p in (a.wtm, a.passed, a.done))

    if a.words:  # the sampler: the k-th valid point, pass when k is the count
        valid = ~invd
        count = valid.sum(1)
        k = (_at(a.words, ctypes.c_int64, b) * (count + 1)) >> 31
        rank = np.cumsum(valid, 1) - 1
        hit = valid & (rank == k[:, None])
        action = np.where(k == count, m, hit.argmax(1)).astype(np.int64)
    else:
        action = _at(a.actions, ctypes.c_int64 if a.action_bytes == 8 else ctypes.c_int32, b).astype(np.int64)
    if a.actions_out:
        _at(a.actions_out, ctypes.c_int32, b)[:] = action.astype(np.int32)

    is_pass = action == m
    oob = (action < 0) | (action > m)
    at = np.clip(action, 0, m - 1)
    invalid = oob | (~is_pass & invd[rows, at])
    frozen = done | invalid
    opp_in = np.where(wtm[:, None], black, white)
    if a.ko_surr:
        surr = (_planes(a.ko_surr, m, b, m) != 0) & keep
        surrounded = ~is_pass & surr[rows, at]
    else:
        r, c = at // n, at % n
        surrounded = ~is_pass.copy()
        for ok, d in ((r > 0, -n), (r < n - 1, n), (c > 0, -1), (c < n - 1, 1)):
            surrounded &= ~ok | opp_in[rows, np.clip(at + d, 0, m - 1)]

    own, theirs = np.where(wtm[:, None], white, black), np.where(wtm[:, None], black, white)
    killed = theirs & (atari == (at + 1)[:, None]) & ~is_pass[:, None]
    captured = killed.sum(1)
    captured_at = np.where(killed, cells, 0).sum(1)
    fz = frozen[:, None]
    mover = np.where(fz, black, own | (~is_pass[:, None] & (cells == at[:, None])))
    opp = np.where(fz, white, theirs & ~killed)
    ko = np.where((captured == 1) & surrounded, captured_at, _NO_KO)
    mover_white = wtm & ~frozen
    white_next = wtm != ~frozen
    passed_next = np.where(frozen, passed, is_pass)
    done_next = np.where(frozen, done, passed & is_pass)

    word = tflood.bundle_flood_plain(torch.from_numpy(mover.reshape(b, n, n)),
                                     torch.from_numpy(opp.reshape(b, n, n))).reshape(b, m).numpy().astype(np.int64)
    anyl, alll = word & _NO_KO, ~(word >> 9) & _NO_KO
    stones = mover | opp
    has = anyl != 0
    one, multi = stones & has & (anyl == alll), stones & has & (anyl != alll)
    got_a, got_b = (word >> 18 & 1) != 0, (word >> 19 & 1) != 0
    mover_area = (mover | (~stones & got_a & ~got_b)).sum(1)
    opp_area = (opp | (~stones & got_b & ~got_a)).sum(1)
    cls = one.astype(np.int64) | multi.astype(np.int64) << 1
    packed = np.where(mover, cls, np.where(opp, cls << 2, 16)) | (~mover).astype(np.int64) << 5
    packed |= (~opp).astype(np.int64) << 6
    dil = _neighbours_or(packed, n)
    possible = ~stones & ((dil & 6) != 0)
    definite = (dil & 9) != 0
    inv = stones | (possible & ~definite & ((dil & 16) == 0)) | (cells == ko[:, None])
    inv = np.where(fz, invd, inv)
    all_mover, all_opp = (dil & 32) == 0, (dil & 64) == 0
    miw = mover_white[:, None]
    all_black, all_white = np.where(miw, all_opp, all_mover), np.where(miw, all_mover, all_opp)
    out_b, out_w = np.where(miw, opp, mover), np.where(miw, mover, opp)
    ko_surr_next = np.where(white_next[:, None], all_black, all_white)

    def put(ptr, ctype, values, count=b):
        if ptr:
            _at(ptr, ctype, count)[:] = values.reshape(-1)

    u8 = ctypes.c_uint8
    put(a.out_black, u8, out_b, b * m)
    put(a.out_white, u8, out_w, b * m)
    put(a.out_invd, u8, inv, b * m)
    put(a.out_atari, ctypes.c_int16, np.where(one, anyl, 0), b * m)
    put(a.out_ko_surr, u8, ko_surr_next, b * m)
    if a.out_states:
        flags = [np.broadcast_to(f[:, None], (b, m)) for f in (white_next, passed_next, done_next)]
        put(a.out_states, u8, np.stack([out_b, out_w, flags[0], inv, flags[1], flags[2]], 1), b * 6 * m)
    black_area = np.where(mover_white, opp_area, mover_area)
    white_area = np.where(mover_white, mover_area, opp_area)
    for ptr, v in ((a.out_wtm, white_next), (a.out_passed, passed_next), (a.out_done, done_next),
                   (a.out_done_row, done_next), (a.out_was_done, done), (a.out_invalid, invalid)):
        put(ptr, u8, v)
    put(a.out_captured, ctypes.c_int32, np.where(frozen, 0, captured))
    put(a.out_black_area, ctypes.c_int32, black_area)
    put(a.out_white_area, ctypes.c_int32, white_area)
    if a.out_reward:
        kc = ((np.float32(black_area) - np.float32(white_area)).astype(np.float32) - np.float32(a.out_komi))
        kc = kc.astype(np.float32)
        if a.out_reward_method == 1:
            reward = np.where(done_next, np.sign(kc), np.float32(0))
        else:
            reward = np.where(done_next, np.where(kc > 0, np.float32(1), np.float32(-1)) * np.float32(m), kc)
        put(a.out_reward, ctypes.c_float, reward.astype(np.float32))


def _emulate_reset(a):
    """``env_sample_launch`` with the reset alone (``reset_finished``)."""
    assert a.reset and not a.words
    b, m = a.batch, a.n * a.n
    done = _at(a.done, ctypes.c_uint8, b) != 0
    for ptr, ctype in ((a.black, ctypes.c_uint8), (a.white, ctypes.c_uint8), (a.invd, ctypes.c_uint8),
                       (a.atari, ctypes.c_int16), (a.ko_surr, ctypes.c_uint8)):
        if ptr:
            _at(ptr, ctype, b * m).reshape(b, m)[done] = 0
    for ptr in (a.wtm, a.passed, a.done):
        _at(ptr, ctypes.c_uint8, b)[done] = 0


@pytest.fixture
def emulated(monkeypatch):
    """Every launch of ``ops.env_step`` on CPU tensors goes to the numpy
    emulation (``env_fused`` and the reset-only ``env_sample``); returns the
    launches by symbol."""
    launched = collections.Counter()

    def launch(lib, args, _dev):
        launched[lib.symbol] += 1
        if lib is env_step.ENV_FUSED:
            _emulate_fused(args)
        elif lib is env_step.ENV_SAMPLE:
            _emulate_reset(args)
        else:
            raise AssertionError(f"{lib.symbol} on the carried path")

    monkeypatch.setattr(env_step, "_launch", launch)
    monkeypatch.setattr(env_step._Check, "device", lambda self: self.seen[0].device)
    monkeypatch.setattr(tstep, "fused_step", lambda boards: tflood.bundle_fits(boards.shape[-1]))
    return launched


def _struct_fields(name, prefix=""):
    """The member names of struct ``name`` in ``csrc/env_step.cu`` in order,
    a nested ``ScoreOut out``'s expanded as ``out_<member>``."""
    source = env_step.SOURCE.read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, source, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        kind, names = line.removeprefix("const ").replace("long long", "long_long").split(None, 1)
        for member in names.split(","):
            member = member.strip().lstrip("*")
            fields += _struct_fields(kind, f"{member}_") if kind == "ScoreOut" else [prefix + member]
    return fields


@pytest.mark.parametrize("struct,name", [(env_step._FusedArgs, "FusedArgs"), (env_step._ScoreArgs, "ScoreArgs")])
def test_the_structs_lie_as_the_kernels_read_them(struct, name):
    assert [f for f, _ in struct._fields_] == _struct_fields(name)
    assert ctypes.sizeof(struct) == 8 * len(struct._fields_)
    assert all(getattr(struct, f).offset == 8 * i for i, (f, _) in enumerate(struct._fields_))


def _equal(got, want, what):
    for i, (x, y) in enumerate(zip(got, want)):
        if y is None:
            assert x is None, (what, i)
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), (what, i)


@contextlib.contextmanager
def _plain():
    """Every step of the block takes the op-by-op code."""
    fused_step = tstep.fused_step
    tstep.fused_step = lambda _boards: False
    try:
        yield
    finally:
        tstep.fused_step = fused_step


def _started(n, b):
    """``b`` games ``n`` random moves in, every third finished and every
    third after a pass."""
    with _plain():
        states = rollout(torch.Generator().manual_seed(b), batch_init_state(b, n, device="cpu"), n,
                         EnvConfig(board_size=n, batch_size=b)).final_states
    states[0::3, 5] = 1
    states[0::3, 3] = 1
    states[1::3, 4] = 1
    return states


@pytest.mark.parametrize("n,b,steps", [(9, 12, 90), (19, 6, 40)])
@pytest.mark.parametrize("auto_reset", [True, False])
@pytest.mark.parametrize("policy", ["sampler", "policy_fn"])
def test_the_carried_rollout_equals_the_op_by_op_rollout(n, b, steps, auto_reset, policy, emulated):
    cfg = EnvConfig(board_size=n, batch_size=b, auto_reset=auto_reset, reward_method=HEURISTIC if n == 9 else REAL,
                    komi=0.0 if n == 9 else 7.5)
    kw = {} if policy == "sampler" else {"policy_fn": uniform_random_actions}
    start = _started(n, b)
    got = rollout(torch.Generator().manual_seed(n), start, steps, cfg, collect_obs=True, **kw)
    assert emulated["env_fused_launch"] == steps
    assert emulated["env_sample_launch"] == (steps if auto_reset and policy == "policy_fn" else 0)
    with _plain():
        want = rollout(torch.Generator().manual_seed(n), start, steps, cfg, collect_obs=True, **kw)
    _equal(got, want, "rollout")


@pytest.mark.parametrize("words", [True, False])
def test_a_window_row_restarts_finished_boards_itself(words, emulated):
    n, b = 9, 8
    start = _started(n, b)
    assert (start[:, 5, 0, 0] != 0).any()
    x = (torch.randint(0, 1 << 31, (b,), generator=torch.Generator().manual_seed(5), dtype=torch.int64) if words
         else torch.tensor([0, 1, 2, 80, 81, 82, -1, 40], dtype=torch.int64))
    cfg = EnvConfig(board_size=n, batch_size=b, reward_method=HEURISTIC)

    def window():
        return (torch.empty((1, b), dtype=torch.int32), torch.empty((1, b)), torch.empty((1, b), dtype=torch.bool),
                torch.empty((1, b), dtype=torch.bool), torch.empty((1, b, 6, n, n), dtype=torch.int8))

    ps = tstep.seed_planes(start)
    kept = [t.clone() for t in ps]
    got_rows = window()
    got = tstep.step_window_row(ps, x, got_rows, 0, cfg, words=words, reset=True)
    assert emulated["env_fused_launch"] == 1 and emulated["env_sample_launch"] == 0
    assert all(torch.equal(p, k) for p, k in zip(ps, kept))  # nothing written in place
    with _plain():
        want_rows = window()
        want = tstep.step_window_row(tstep.seed_planes(start), x, want_rows, 0, cfg, words=words, reset=True)
    _equal(got, want, "planes")
    _equal(got_rows, want_rows, "rows")


def _hand_boards(n):
    """Boards play never makes beside played ones: a ko capture, a group
    without a liberty, cells of both colours, a finished board."""
    ko = crafted_state(n, black=[(1, 2), (2, 1), (3, 2)], white=[(1, 3), (2, 4), (3, 3), (2, 2)])
    dead = crafted_state(n, black=[(0, 0), (0, 1)], white=[(1, 0), (1, 1), (0, 2)])
    dead[1, 0, 0] = 1  # a white stone under the black one: both colours
    done = crafted_state(n, black=[(1, 1)], done=True)
    return np.stack([ko, dead, done])


@pytest.mark.parametrize("n", [5, 9, 19])
def test_step_planes_on_carried_planes_equals_the_op_by_op_step(n, emulated):
    states = torch.cat([torch.from_numpy(_hand_boards(n)), _started(n, 9)])
    b = states.shape[0]
    ps = tstep.seed_planes(states)
    rng = np.random.default_rng(n)
    for step, dtype in enumerate((torch.int64, torch.int32, torch.int64)):
        acts = rng.integers(-2, n * n + 3, b)
        acts[:3] = [(2 * n + 3) if step == 0 else n * n, 2, 0]  # the ko capture, a move, a finished board
        acts = torch.from_numpy(np.where(rng.random(b) < 0.2, rng.choice([-(1 << 40), 1 << 40], b), acts)
                                if dtype == torch.int64 else acts).to(dtype)
        got = tstep.step_planes(ps, acts)
        want = tstep.step_planes_plain(ps, acts)
        _equal(got[0], want[0], f"planes {step}")
        _equal(got[1], want[1], f"info {step}")
        ps = want[0]
    assert emulated["env_fused_launch"] == 3
