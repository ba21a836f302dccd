"""Compiled forms: a function captured once into a CUDA graph and replayed
(the port's counterpart of ``jax.jit``).

``compiled(fn, static_argnames=...)`` returns a callable with ``fn``'s
signature.  On CUDA tensors the first call with a given key runs ``fn``
eagerly on a side stream (the warmup PyTorch's CUDA graph notes require: it
also makes the lazy state, such as the kernels' device queries and the
optimizer's moments) and returns that result; it then captures ``fn`` into a
``torch.cuda.CUDAGraph``.  Every later call with the key copies its tensors
into the graph's static inputs, replays the graph from one host call, and
returns clones of the static outputs, so a caller keeps what it was given
while the graph runs again.  On CPU tensors ``fn`` is called as it is, as the
kernels' plain versions serve the CPU.

The key holds the shapes, dtypes and devices of the tensor arguments, the
values of the static arguments, the device of each ``torch.Generator``
argument and the value of every function a module registered with
``register_key_part`` (the ``GYMGO_ABLATE`` tokens, the Gumbel tree layout),
so a switch never replays a graph captured under another setting.  Every
other argument is a tree (tuples, named tuples, lists, dicts) of tensors,
generators and ``None``.

Nested calls: a compiled function called while a graph is being captured
(a search inside a captured self-play move) runs its function inline, so its
kernels join the outer graph; so does one called during the eager first run
of an outer key on the side stream, which would otherwise capture a graph
of its own that nothing replays.  Only the outermost compiled call captures
and replays.  Inside ``with eager():`` every compiled call runs its function
as it is: a path's eager form, to compare with or time against its graphs.

What a graph may hold:

* No host sync: a sync inside the capture makes the capture fail, and a failed
  capture raises; nothing falls back to eager running on the card.  Every
  flood on the card is a hand kernel that makes none, up to 181x181.  Larger
  boards run eagerly (``core.flood.capturable``, which ``compiled(...,
  when=)`` reads per call), where the kernels raise.
* Draws from a ``torch.Generator`` argument: the graph draws from a
  generator of its own, registered with it
  (``CUDAGraph.register_generator_state``), which each replay sets to the
  caller's generator's state and whose state after the replay the caller's
  generator takes, so a replay draws what the eager call would and advances
  the generator as that call would.  A CPU generator beside CUDA tensors
  raises.
* Host values are baked in at the capture: a ``policy_fn`` that reads
  Python state (an iterator of recorded actions) replays the values it gave
  the capture; pass such policies to the eager function.
* Tensors that ``fn`` reads or updates in place other than its arguments (a
  net's parameters, an optimizer's moments, a replay's rows) are read and
  written where they lay at the capture: they must stay the same tensors.

Layers and counts (``utils.tracing``): each capture builds the graph's
layer table from the spans its function opens, and each replay adds the
counts taken during the capture (the hand kernels' launches,
``ops.cuda_lib.CudaKernelLib.launches``, among them), so the counters count
what a replay runs.  A replay runs under the spans ``graph.copy_in``,
``graph.replay.<id>`` and ``graph.clone_out``.
"""

from __future__ import annotations

import contextlib
import inspect
import time
from typing import Callable, NamedTuple

import torch

from gymgo_tpu_torch.utils import tracing

__all__ = ["compiled", "Compiled", "CapturedGraph", "register_key_part", "eager"]

# functions of no argument whose values join every key (``register_key_part``)
_KEY_PARTS: list = []
# > 0 inside ``eager()`` (an outer key's eager first run among them): compiled calls run inline
_inline = 0


def register_key_part(part: Callable[[], object]) -> None:
    """Add ``part()``, a hashable value of a process-wide switch that a
    compiled function reads (a tree layout), to the key of every later
    call, so a graph captured under one setting never replays under
    another."""
    _KEY_PARTS.append(part)


@contextlib.contextmanager
def eager():
    """Within the block every compiled call runs its function as it is (the
    eager form of a path); an outer key's eager first run is such a block."""
    global _inline
    _inline += 1
    try:
        yield
    finally:
        _inline -= 1


def _nested() -> bool:
    """True inside ``eager()`` or a capture: a compiled call there runs its
    function inline."""
    return _inline > 0 or (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())


def _map(fn, tree):
    """``fn`` on every tensor and generator of ``tree``; containers rebuilt,
    other leaves passed through."""
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        return fn(tree)
    if isinstance(tree, tuple):
        items = [_map(fn, x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, list):
        return [_map(fn, x) for x in tree]
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def _spec(tree, leaves: list):
    """The hashable structure of an argument tree; its tensors and generators
    are appended to ``leaves`` in the order ``_map`` visits them."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, torch.Generator):
        leaves.append(tree)
        return ("generator", tree.device)
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_spec(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _spec(v, leaves)) for k, v in tree.items()))
    raise TypeError(f"a compiled function takes tensors, generators and trees of them; got {type(tree).__name__} "
                    "(name the argument in static_argnames to key the graph on its value)")


def _graph_device(leaves) -> torch.device | None:
    """The one CUDA device of the tensor leaves, or None when none lies on a
    card (the CPU path)."""
    devices = {x.device for x in leaves if isinstance(x, torch.Tensor)}
    if not any(d.type == "cuda" for d in devices):
        return None
    if len(devices) > 1:
        raise ValueError(f"a CUDA graph runs on one card; the tensors lie on {sorted(map(str, devices))}")
    if any(isinstance(g, torch.Generator) and g.device.type != "cuda" for g in leaves):
        raise ValueError("a CPU generator beside CUDA tensors: its draws would be baked into the graph")
    return devices.pop()


class CapturedGraph:
    """One captured graph: a static input for each leaf of the arguments (a
    tensor for a tensor, the graph's own registered generator for a
    generator), the static outputs, its layer table (``utils.tracing``: the
    graph's id, nodes, device operations, layers and captured counts) and
    its capture seconds."""

    def __init__(self, graph, static_in, static_out, table: tracing.LayerTable, capture_seconds):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.table = table
        self.capture_seconds = capture_seconds
        self.replays = 0
        self.span = f"graph.replay.{table.graph_id}"

    @property
    def nodes(self) -> int:
        return self.table.nodes

    def replay(self, leaves):
        """Copy ``leaves`` in (a generator's state into the graph's own),
        replay, hand each generator the state the replay left, and return
        clones of the static outputs."""
        pairs = list(zip(self.static_in, leaves))
        with tracing.span("graph.copy_in"):
            for static, x in pairs:
                if isinstance(x, torch.Generator):
                    static.set_state(x.get_state())
                else:
                    static.copy_(x)
        with tracing.span(self.span):
            self.graph.replay()
        for static, x in pairs:
            if isinstance(x, torch.Generator):
                x.set_state(static.get_state())
        tracing.replayed(self.table)
        self.replays += 1
        with tracing.span("graph.clone_out"):
            return _map(torch.Tensor.clone, self.static_out)


class _Call(NamedTuple):
    bound: inspect.BoundArguments
    dynamic: tuple  # names of the arguments that are trees of tensors
    leaves: list  # their tensors and generators, in ``_map``'s order
    key: tuple


def _capture(fn, call: _Call, device) -> tuple:
    """The first call of a key: ``fn`` run eagerly on a side stream (its
    result is returned), then captured.  Returns ``(result, CapturedGraph)``."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with eager(), torch.cuda.stream(side):
        out = fn(*call.bound.args, **call.bound.kwargs)
    current.wait_stream(side)
    # the result was made on the side stream and is used on the current one
    _map(lambda t: t.record_stream(current), out)

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    static_in = []
    for x in call.leaves:
        if isinstance(x, torch.Generator):
            # the graph draws from a generator of its own, whose state each
            # replay takes from the caller's and hands back
            static_in.append(torch.Generator(device=x.device))
            graph.register_generator_state(static_in[-1])
        else:
            static_in.append(x.clone())
    it = iter(static_in)
    bound = inspect.BoundArguments(call.bound.signature, dict(call.bound.arguments))
    for name in call.dynamic:
        bound.arguments[name] = _map(lambda _x: next(it), bound.arguments[name])
    t0 = time.perf_counter()
    try:
        with tracing.capturing(tracing.new_graph_id()) as capture, torch.cuda.graph(graph):
            static_out = fn(*bound.args, **bound.kwargs)
    except Exception as e:
        # a failed capture leaves the generators it drew from in capture mode:
        # the default one gets a fresh copy of its state
        default = torch.cuda.default_generators[device.index]
        default.graphsafe_set_state(default.clone_state())
        raise RuntimeError(f"capturing {getattr(fn, '__name__', fn)!r} into a CUDA graph failed (a host sync, "
                           f"or work on another stream or card, inside it?): {e} ({e.__context__})") from e
    table = tracing.finish(capture, graph.raw_cuda_graph())
    graph.instantiate()
    seconds = time.perf_counter() - t0
    return out, CapturedGraph(graph, static_in, static_out, table, seconds)


class Compiled:
    """``fn`` with its CUDA graphs, one per key (see the module docstring).
    ``graphs`` maps each key to its ``CapturedGraph``; ``when``, if given,
    maps the bound arguments (a dict by name) to whether a call on the card
    may be captured, and where it says no ``fn`` runs as it is."""

    def __init__(self, fn: Callable, static_argnames=(), when: Callable[[dict], bool] | None = None):
        self.fn = fn
        self.when = when
        self.signature = inspect.signature(fn)
        self.static_argnames = frozenset(static_argnames)
        unknown = self.static_argnames.difference(self.signature.parameters)
        if unknown:
            raise ValueError(f"static_argnames {sorted(unknown)} are not parameters of {fn}")
        self.graphs: dict = {}
        self.__name__ = getattr(fn, "__name__", type(fn).__name__)
        self.__doc__ = getattr(fn, "__doc__", None)

    def _call(self, args, kwargs) -> _Call:
        """The call's bound arguments and key: each static argument's value,
        each other argument's structure, and the registered parts."""
        bound = self.signature.bind(*args, **kwargs)
        leaves, dynamic, parts = [], [], []
        for name, value in bound.arguments.items():
            if name in self.static_argnames:
                parts.append((name, value))
            else:
                dynamic.append(name)
                parts.append((name, _spec(value, leaves)))
        key = (tuple(parts), tuple(part() for part in _KEY_PARTS))
        return _Call(bound, tuple(dynamic), leaves, key)

    def __call__(self, *args, **kwargs):
        call = self._call(args, kwargs)
        device = _graph_device(call.leaves)
        if device is None or _nested() or (self.when is not None and not self.when(call.bound.arguments)):
            return self.fn(*args, **kwargs)
        graph = self.graphs.get(call.key)
        if graph is None:
            out, self.graphs[call.key] = _capture(self.fn, call, device)
            return out
        return graph.replay(call.leaves)


def compiled(fn: Callable, static_argnames=(), when: Callable[[dict], bool] | None = None) -> Compiled:
    """``fn`` captured into a CUDA graph per key and replayed (``jax.jit``'s
    counterpart; the module docstring says what a graph may hold).  ``when``
    keeps the calls it refuses eager (a path that syncs,
    ``core.flood.capturable``)."""
    return Compiled(fn, static_argnames, when)
