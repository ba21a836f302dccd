"""Faults planted in the program's timed path, and the control, for the
readings that set the limits (``controls.py``) and for the test that the
check catches each fault (``tests/test_portbench_faults.py``).  No run of
the benchmark plants any.

Each is a context manager that patches the program's modules and undoes
the patch when it ends:

* ``unchanged``: the env step (or the front end's board step) returns the
  state it was given;
* ``half_batch``: the second half of a batch's results are copies of the
  first half's;
* ``altered``: the answer is altered where it is produced: the rollout's
  recorded moves, or the search's chosen move (another visited candidate);
* ``first_legal``: the sampler takes the first legal move, not a uniform one;
* ``ko_off`` (the go19 control): the program's own switch that drops the
  ko rule (``GYMGO_ABLATE=ko``);
* ``float8`` (the agz20 control): the plain reference's network with every
  convolution and dense layer in float8 e4m3 (``reference.aznet``'s
  ``fp8``), one step below the configuration's bfloat16, in the program's
  network's place.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


class Float8Reference(torch.nn.Module):
    """The reference's forward in float8 over the benchmark's weights, called
    as the program calls its network: canonical states in, ``(logits,
    value)`` float32 out."""

    def __init__(self, weights: dict):
        super().__init__()
        self.weights = weights
        # the weights as parameters, so the front end finds the network's device
        self.held = torch.nn.ParameterList(torch.nn.Parameter(t, requires_grad=False) for t in weights.values())

    def forward(self, states):
        from portbench.reference import aznet

        return aznet.forward(self.weights, states, fp8=True)


def _halve(x):
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    return torch.cat([x[: (x.shape[0] + 1) // 2], x[: x.shape[0] // 2]])


def _halve_time_major(x):
    return _halve(x.transpose(0, 1)).transpose(0, 1).contiguous()


@contextlib.contextmanager
def plant(kind: str, driver: str):
    """Plant fault ``kind`` for the cells of ``driver``."""
    from gymgo_tpu_torch import gogame
    from gymgo_tpu_torch.core import actions, step
    from gymgo_tpu_torch.env.batch_env import BatchGoEnv
    from gymgo_tpu_torch.rl import gumbel_mcts

    if kind == "ko_off":
        previous = step.set_ablate({"ko"})
        try:
            yield
        finally:
            step.set_ablate(previous)
        return
    if kind == "float8":
        from portbench.lib import weights

        def make(program_net):
            def control(config, seed, device):
                _, w = program_net(config, seed, device)
                return Float8Reference(w), w
            return control
        with _patched(weights, "program_net", make):
            yield
        return
    if kind == "first_legal":
        def make(_):
            return lambda word, valid: actions.kth_valid_actions(valid, torch.zeros_like(word))
        with _patched(actions, "uniform_from_words", make):
            yield
        return
    if driver == "env_window":
        def make(rollout):
            def broken(self, generator, states, num_steps, **kw):
                r = rollout(self, generator, states, num_steps, **kw)
                if kind == "unchanged":
                    return r._replace(final_states=states.clone())
                if kind == "half_batch":
                    return r._replace(actions=_halve_time_major(r.actions), rewards=_halve_time_major(r.rewards),
                                      dones=_halve_time_major(r.dones), invalid=_halve_time_major(r.invalid),
                                      final_states=_halve(r.final_states))
                if kind == "altered":
                    return r._replace(actions=(r.actions + 1) % (states.shape[-1] ** 2 + 1))
                raise ValueError(kind)
            return broken
        with _patched(BatchGoEnv, "rollout", make):
            yield
        return
    if kind == "unchanged" and driver == "batched_search":
        def make(env_step):
            def broken(self, states, acts):
                _, res = env_step(self, states, acts)
                return states, res._replace(obs=states.clone())
            return broken
        with _patched(BatchGoEnv, "step", make):
            yield
        return
    if kind == "unchanged" and driver == "gtp_genmove":
        with _patched(gogame, "next_state", lambda _: lambda state, action, **kw: state):
            yield
        return
    if kind in ("half_batch", "altered"):
        def make(search):
            def broken(generator, states, net, *args, **kwargs):
                res = search(generator, states, net, *args, **kwargs)
                if kind == "half_batch":
                    return type(res)(*(_halve(x) for x in res))
                cand = res.sampled_actions
                other = torch.where(cand[:, 0] == res.actions, cand[:, 1], cand[:, 0])
                return res._replace(actions=other)
            return broken
        with _patched(gumbel_mcts, "run_gumbel_mcts", make):
            yield
        return
    raise ValueError(f"no fault {kind!r} for {driver}")


# the faults each driver's cells can have
FAULTS = {
    "env_window": ("unchanged", "half_batch", "altered", "first_legal"),
    "batched_search": ("unchanged", "half_batch", "altered"),
    "gtp_genmove": ("unchanged", "altered"),
}
