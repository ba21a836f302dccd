"""The env step's hand CUDA kernels (``csrc/env_step.cu``) and their wrappers.

Replaces no Pallas kernel: the kernels are the counterpart of the fusion XLA
makes of the JAX package's step (``gymgo_tpu/core/step.py``), its sampler and
its auto-reset.  Around the unchanged bundle flood (``ops/bundle_flood.py``)
they compute what ``core.step.step_planes_plain``, the rollout's
``core.actions.uniform_from_words`` and ``core.step.reset_finished``
compute, bit for bit.  ``core.step`` decides when they run
(``core.step.fused_step``); the op-by-op PyTorch code stays their plain
version.  Built and loaded at first use by ``gymgo_tpu_torch.ops.cuda_lib``.

Five entry points, each with its own launch counter
(``launches.env_<name>_launch``):

* ``fused``: the whole step of the carried path (planes with the carried
  ``atari`` plane) in one launch: the auto-reset and the sampler, the rules,
  the bundle flood's labelling and the score, a warp a board with nothing
  written to device memory in between;
* ``sample``: the auto-reset of finished boards in place, then each board's
  action from its random word (``core.actions.draw_words``);
* ``split``: the two contiguous stone planes of int8 states, which the
  bundle flood takes;
* ``rules``: the rules before the flood: the stone planes the flood takes
  and a per-board word;
* ``score``: after the flood: the word unpacked, the areas, the reward, the
  next invalid mask, ko-surround map and atari plane, and every output.

Each wrapper checks its tensors and raises on what the kernel does not take
(the device last, so a CPU test reaches every other check); it launches on
the current stream and does not synchronise.  The last four are the
stateless path's chain around the bundle flood, and ``sample`` is
``core.step.reset_finished``'s.
"""

from __future__ import annotations

import ctypes

import torch

from gymgo_tpu_torch.config import HEURISTIC, REAL
from gymgo_tpu_torch.core.flood import MAX_BUNDLE_CELLS
from gymgo_tpu_torch.ops.bundle_flood import BUNDLE_FLOOD
from gymgo_tpu_torch.ops.cuda_lib import CSRC, CudaKernelLib

__all__ = ["ENV_FUSED", "ENV_SAMPLE", "ENV_SPLIT", "ENV_RULES", "ENV_SCORE", "KERNELS", "labellings", "fused", "sample",
           "split", "rules", "score"]

SOURCE = CSRC / "env_step.cu"
_P, _L = ctypes.c_void_p, ctypes.c_longlong
# each launcher: (a pointer to its arguments' struct, stream)
ENV_SAMPLE = CudaKernelLib(SOURCE, "env_sample_launch", (_P, _P))
ENV_SPLIT = CudaKernelLib(SOURCE, "env_split_launch", (_P, _P))
ENV_RULES = CudaKernelLib(SOURCE, "env_rules_launch", (_P, _P))
ENV_SCORE = CudaKernelLib(SOURCE, "env_score_launch", (_P, _P))
ENV_FUSED = CudaKernelLib(SOURCE, "env_fused_launch", (_P, _P))
KERNELS = (ENV_SAMPLE, ENV_SPLIT, ENV_RULES, ENV_SCORE, ENV_FUSED)
_BYTE = (torch.bool, torch.int8, torch.uint8)
_REWARD = {None: 0, REAL: 1, HEURISTIC: 2}


def labellings() -> int:
    """The bundle labellings run on the card so far: the bundle flood's
    launches and ``env_fused``'s, which labels its boards inside."""
    return BUNDLE_FLOOD.launches + ENV_FUSED.launches


def _struct(name, fields):
    """A ctypes struct of 8-byte fields, laid out as ``csrc/env_step.cu``'s
    struct of the same fields: ``p`` a pointer, ``i`` a long long, ``d`` a
    double."""
    kinds = {"p": _P, "i": _L, "d": ctypes.c_double}
    return type(name, (ctypes.Structure,), {"_fields_": [(f, kinds[k]) for f, k in fields]})


_SampleArgs = _struct("SampleArgs", [
    ("black", "p"), ("white", "p"), ("invd", "p"), ("atari", "p"), ("ko_surr", "p"), ("wtm", "p"),
    ("passed", "p"), ("done", "p"), ("words", "p"), ("actions", "p"), ("batch", "i"), ("n", "i"), ("reset", "i")])
_SplitArgs = _struct("SplitArgs", [("states", "p"), ("black", "p"), ("white", "p"), ("batch", "i"), ("n", "i")])
_RulesArgs = _struct("RulesArgs", [
    ("black", "p"), ("white", "p"), ("invd", "p"), ("plane_stride", "i"), ("wtm", "p"), ("passed", "p"),
    ("done", "p"), ("flag_stride", "i"), ("atari", "p"), ("ko_surr", "p"), ("word", "p"), ("actions", "p"),
    ("action_bytes", "i"), ("actions_out", "p"), ("mover", "p"), ("opp", "p"), ("info", "p"), ("batch", "i"),
    ("n", "i")])
# the step's outputs: the fields of csrc/env_step.cu's `ScoreOut out`
_OUT = [("out_" + f, k) for f, k in (
    ("black", "p"), ("white", "p"), ("invd", "p"), ("atari", "p"), ("ko_surr", "p"), ("states", "p"), ("wtm", "p"),
    ("passed", "p"), ("done", "p"), ("done_row", "p"), ("was_done", "p"), ("invalid", "p"), ("captured", "p"),
    ("black_area", "p"), ("white_area", "p"), ("reward", "p"), ("komi", "d"), ("reward_method", "i"))]
_ScoreArgs = _struct("ScoreArgs", [
    ("mover", "p"), ("opp", "p"), ("word", "p"), ("info", "p"), ("invd_in", "p"), ("invd_stride", "i"), *_OUT,
    ("batch", "i"), ("n", "i")])
_FusedArgs = _struct("FusedArgs", [
    ("black", "p"), ("white", "p"), ("invd", "p"), ("plane_stride", "i"), ("wtm", "p"), ("passed", "p"),
    ("done", "p"), ("flag_stride", "i"), ("atari", "p"), ("ko_surr", "p"), ("words", "p"), ("actions", "p"),
    ("action_bytes", "i"), ("actions_out", "p"), ("reset", "i"), *_OUT, ("batch", "i"), ("n", "i")])


def _ptr(t):
    return None if t is None else t.data_ptr()


class _Check:
    """The checks of one call: every tensor ``(B, ...)`` of one batch and
    board size, the device checked last (``device``)."""

    def __init__(self, name: str, b: int, n: int):
        if n * n > MAX_BUNDLE_CELLS:
            raise ValueError(f"{name} needs N*N <= {MAX_BUNDLE_CELLS}, got N={n}")
        self.name, self.b, self.n, self.seen = name, b, n, []

    def _fail(self, what, t, want):
        raise ValueError(f"{self.name}: {what} must be {want}, got {tuple(t.shape)} {t.dtype} with strides "
                         f"{t.stride()}")

    def tensor(self, what, t, dtypes, shape, contiguous=True):
        """``t`` of one of ``dtypes`` and ``shape``; contiguous, or (planes
        and flags that are views of states) of any stride between boards."""
        if t is None:
            return None
        if t.dtype not in dtypes:
            raise TypeError(f"{self.name}: {what} takes {'/'.join(map(str, dtypes))}, got {t.dtype}")
        if tuple(t.shape) != (self.b,) + shape:
            self._fail(what, t, f"of shape {(self.b,) + shape}")
        inner = t[0].is_contiguous() if self.b else True
        if not (t.is_contiguous() if contiguous else inner):
            self._fail(what, t, "contiguous" if contiguous else "contiguous within a board")
        self.seen.append(t)
        return t

    def planes(self, what, t, dtypes=_BYTE, contiguous=True):
        return self.tensor(what, t, dtypes, (self.n, self.n), contiguous)

    def flags(self, what, t, dtypes=(torch.bool,), contiguous=True):
        return self.tensor(what, t, dtypes, (), contiguous)

    def same_stride(self, what, *ts):
        if len({t.stride(0) for t in ts}) != 1:
            raise ValueError(f"{self.name}: {what} must share their stride between boards, got "
                             f"{[t.stride(0) for t in ts]}")
        return ts[0].stride(0)

    def device(self) -> torch.device:
        dev = self.seen[0].device
        if dev.type != "cuda" or any(t.device != dev for t in self.seen):
            raise ValueError(f"{self.name} needs every tensor on one CUDA device, got "
                             f"{sorted({str(t.device) for t in self.seen})}")
        return dev


def _launch(lib, args, dev):
    lib.launch(ctypes.addressof(args), device=dev)


def sample(black, white, invd, wtm, passed, done, *, atari=None, ko_surr=None, reset: bool,
           words=None, actions=None) -> None:
    """In place: with ``reset``, zero every plane and flag of the boards
    whose ``done`` is set (``atari``, ``ko_surr`` too); then, given
    ``words`` (int64 ``(B,)`` from ``core.actions.draw_words``, in
    ``[0, 2**31)``), write each board's uniform action into ``actions``
    (int32 ``(B,)``): the k-th valid point in row-major order, pass ranked
    last, with k = word * (valid + 1) >> 31.  Planes bool ``(B, N, N)``,
    flags bool ``(B,)``, all contiguous."""
    b, n = black.shape[0], black.shape[-1]
    c = _Check("env_step.sample", b, n)
    for what, t in (("black", black), ("white", white), ("invd", invd), ("ko_surr", ko_surr)):
        c.planes(what, t, (torch.bool,))
    c.planes("atari", atari, (torch.int16,))
    for what, t in (("wtm", wtm), ("passed", passed), ("done", done)):
        c.flags(what, t)
    if (words is None) != (actions is None):
        raise ValueError("env_step.sample takes words and actions together")
    c.flags("words", words, (torch.int64,))
    c.flags("actions", actions, (torch.int32,))
    dev = c.device()
    _launch(ENV_SAMPLE, _SampleArgs(_ptr(black), _ptr(white), _ptr(invd), _ptr(atari), _ptr(ko_surr), _ptr(wtm),
                                    _ptr(passed), _ptr(done), _ptr(words), _ptr(actions), b, n, int(reset)), dev)


def split(states: torch.Tensor):
    """``(black, white)``: the stone planes of states ``(B, 6, N, N)``
    (bool, int8 or uint8, contiguous) as contiguous bool ``(B, N, N)``
    planes, the bundle flood's inputs."""
    if states.dim() != 4 or states.shape[1] != 6:
        raise ValueError(f"env_step.split takes (B, 6, N, N) states, got {tuple(states.shape)}")
    b, n = states.shape[0], states.shape[-1]
    c = _Check("env_step.split", b, n)
    c.tensor("states", states, _BYTE, (6, n, n))
    dev = c.device()
    black = torch.empty((b, n, n), dtype=torch.bool, device=dev)
    white = torch.empty_like(black)
    _launch(ENV_SPLIT, _SplitArgs(_ptr(states), _ptr(black), _ptr(white), b, n), dev)
    return black, white


def _inputs(c, black, white, invd, wtm, passed, done):
    """Check the board before the move: planes and flags of bool, int8 or
    uint8, contiguous within a board, each group with one stride between
    boards; returns the two strides."""
    for what, t in (("black", black), ("white", white), ("invd", invd)):
        c.planes(what, t, contiguous=False)
    for what, t in (("wtm", wtm), ("passed", passed), ("done", done)):
        c.flags(what, t, _BYTE, contiguous=False)
    return (c.same_stride("black, white and invd", black, white, invd),
            c.same_stride("wtm, passed and done", wtm, passed, done))


def _outputs(c, black=None, white=None, invd=None, atari=None, ko_surr=None, states=None, wtm=None, passed=None,
             done=None, done_row=None, was_done=None, invalid=None, captured=None, black_area=None,
             white_area=None, reward=None, komi: float = 0.0, reward_method=None):
    """Check a step's outputs (``score``'s); returns the values of the
    struct's ``_OUT`` fields."""
    for what, t in (("black", black), ("white", white), ("invd", invd), ("ko_surr", ko_surr)):
        c.planes(what, t, (torch.bool,))
    c.planes("atari", atari, (torch.int16,))
    c.tensor("states", states, _BYTE, (6, c.n, c.n))
    for what, t in (("wtm", wtm), ("passed", passed), ("done", done), ("done_row", done_row),
                    ("was_done", was_done), ("invalid", invalid)):
        c.flags(what, t)
    for what, t in (("captured", captured), ("black_area", black_area), ("white_area", white_area)):
        c.flags(what, t, (torch.int32,))
    c.flags("reward", reward, (torch.float32,))
    if reward_method not in _REWARD or (reward is None) != (reward_method is None):
        raise ValueError(f"{c.name} takes a reward output with a reward method of {REAL!r} or {HEURISTIC!r}, "
                         f"got {reward_method!r}")
    tensors = (black, white, invd, atari, ko_surr, states, wtm, passed, done, done_row, was_done, invalid, captured,
               black_area, white_area, reward)
    return [_ptr(t) for t in tensors] + [float(komi), _REWARD[reward_method]]


def fused(board, *, words=None, actions=None, actions_out=None, reset: bool = False, **outputs) -> None:
    """One step of the carried path in one launch, into ``outputs`` (the
    outputs of ``score``, each may be None; none may overlap an input).

    ``board`` is the board before the move, a ``core.step.PlanesState``
    ``(black, white, invd, wtm, passed, done, atari, ko_surr)``: the planes
    and flags as ``rules`` takes them, the carried ``atari`` plane (int16
    ``(B, N, N)``) and ``ko_surr`` (bool ``(B, N, N)``, or None).  Given
    ``words`` (int64 ``(B,)`` from ``core.actions.draw_words``) each board's
    action is the uniform sampler's, as ``sample`` picks it; else the
    ``actions`` (int32 or int64 ``(B,)``) are played.  ``actions_out``
    (int32 ``(B,)``) gets the actions played.  With ``reset`` a finished
    board restarts as the empty board, as after ``sample``'s reset, and
    nothing is written in place.
    """
    black, white, invd, wtm, passed, done, atari, ko_surr = board
    b, n = black.shape[0], black.shape[-1]
    c = _Check("env_step.fused", b, n)
    plane_stride, flag_stride = _inputs(c, black, white, invd, wtm, passed, done)
    if atari is None:
        raise ValueError("env_step.fused takes the carried atari plane")
    c.planes("atari", atari, (torch.int16,))
    c.planes("ko_surr", ko_surr, (torch.bool,))
    if (words is None) == (actions is None):
        raise ValueError("env_step.fused takes either the sampler's words or the actions")
    c.flags("words", words, (torch.int64,))
    c.flags("actions", actions, (torch.int32, torch.int64))
    c.flags("actions_out", actions_out, (torch.int32,))
    out = _outputs(c, **outputs)
    dev = c.device()
    _launch(ENV_FUSED, _FusedArgs(
        _ptr(black), _ptr(white), _ptr(invd), plane_stride, _ptr(wtm), _ptr(passed), _ptr(done), flag_stride,
        _ptr(atari), _ptr(ko_surr), _ptr(words), _ptr(actions), 8 if actions is None else actions.element_size(),
        _ptr(actions_out), int(reset), *out, b, n), dev)


def rules(black, white, invd, wtm, passed, done, actions, *, atari=None, ko_surr=None, word=None,
          actions_out=None):
    """``(mover, opp, info)``: the rules of the step before its flood.

    ``black``/``white``/``invd`` ``(B, N, N)`` and ``wtm``/``passed``/``done``
    ``(B,)`` are bool, int8 or uint8, contiguous within a board, each group
    with one stride between boards (planes, or views of int8 states).
    ``actions`` int32 or int64 ``(B,)``.  Captures come from the carried
    ``atari`` (int16 ``(B, N, N)``) or, without it, from ``word``, the
    bundle word of the board before the move (int32 ``(B, N, N)``); the ko
    probe from ``ko_surr`` (bool ``(B, N, N)``) or the opponent's stones.
    ``actions_out`` (int32 ``(B,)``) gets the actions.  Returns the uint8
    stone planes the bundle flood takes and ``score``'s int32 word a board.
    """
    b, n = black.shape[0], black.shape[-1]
    c = _Check("env_step.rules", b, n)
    plane_stride, flag_stride = _inputs(c, black, white, invd, wtm, passed, done)
    if (atari is None) == (word is None):
        raise ValueError("env_step.rules takes either the carried atari plane or the word before the move")
    c.planes("atari", atari, (torch.int16,))
    c.planes("ko_surr", ko_surr, (torch.bool,))
    c.planes("word", word, (torch.int32,))
    c.flags("actions", actions, (torch.int32, torch.int64))
    c.flags("actions_out", actions_out, (torch.int32,))
    dev = c.device()
    mover = torch.empty((b, n, n), dtype=torch.uint8, device=dev)
    opp = torch.empty_like(mover)
    info = torch.empty((b,), dtype=torch.int32, device=dev)
    _launch(ENV_RULES, _RulesArgs(
        _ptr(black), _ptr(white), _ptr(invd), plane_stride, _ptr(wtm), _ptr(passed), _ptr(done), flag_stride,
        _ptr(atari), _ptr(ko_surr), _ptr(word), _ptr(actions), actions.element_size(), _ptr(actions_out),
        _ptr(mover), _ptr(opp), _ptr(info), b, n), dev)
    return mover, opp, info


def score(mover, opp, word, info, invd_in, **outputs) -> None:
    """The step after its flood, into ``outputs`` (each may be None).

    ``mover``/``opp`` (uint8 or bool) and ``info`` are ``rules``', ``word``
    the bundle word of ``mover``/``opp``;
    ``invd_in`` ``(B, N, N)`` (contiguous within a board) is what a frozen
    board keeps.  Outputs: the planes ``black``, ``white``, ``invd``,
    ``ko_surr`` bool, ``atari`` int16 ``(B, N, N)``; ``states``
    ``(B, 6, N, N)`` (bool, int8 or uint8); flags ``wtm``, ``passed``,
    ``done``, ``done_row``, ``was_done``, ``invalid`` bool ``(B,)``;
    ``captured``, ``black_area``, ``white_area`` int32 ``(B,)``; ``reward``
    float32 ``(B,)``, from ``komi`` and ``reward_method`` (``config.REAL`` or
    ``HEURISTIC``) as ``core.score.reward_from_areas`` computes it.  All
    contiguous.
    """
    b, n = mover.shape[0], mover.shape[-1]
    c = _Check("env_step.score", b, n)
    c.planes("mover", mover, (torch.uint8, torch.bool))
    c.planes("opp", opp, (mover.dtype,))
    c.planes("word", word, (torch.int32,))
    c.flags("info", info, (torch.int32,))
    c.planes("invd_in", invd_in, contiguous=False)
    out = _outputs(c, **outputs)
    dev = c.device()
    _launch(ENV_SCORE, _ScoreArgs(_ptr(mover), _ptr(opp), _ptr(word), _ptr(info), _ptr(invd_in), invd_in.stride(0),
                                  *out, b, n), dev)
