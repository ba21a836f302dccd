"""Layer spans and counters of the port, which survive CUDA-graph capture.

``span(name)`` marks one layer of the program around the code that runs it
(``env.step``, ``search.net``, ``graph.replay.<id>``, ``sync.<site>``).  While
a ``torch.profiler`` runs (or ``torch.autograd.profiler.emit_nvtx``), it is a
``record_function`` range named ``gymgo.<name>``, so the profiler's timeline
holds the spans beside the card's operations.  While a CUDA graph is being
captured (``utils.graphs``), each span's entry and exit also mark how many of
the graph's device operations (its kernel, memcpy and memset nodes) come
before it.  From those marks the capture builds the graph's ``LayerTable``:
for each device operation of a replay, in the order the card runs it, the
``/``-joined path of the spans open when it was captured.  A replay runs no
Python inside the graph, so the table is how a replay's operations are put
down to layers.  Outside a profile and a capture a span costs one check and
makes nothing.

``count(name, n)`` adds to a process-wide counter (``counters``).  Counts
taken while a graph is captured go to its table instead, and each replay of
the graph adds them again (``replayed``), so the launches of the hand kernels
(``launches.<symbol>``, read as ``ops.cuda_lib.CudaKernelLib.launches``), the
boards the search's network evaluates (``search.net_rows``), and over a
learned model the boards through its dynamics (``search.dynamics_rows``) and
the bytes its gather of hidden states must move (``search.latent_bytes``)
count what each replay runs.  A reader of a trace counts a traced section's by the
table: each ``gymgo.graph.replay.<id>`` span in it adds ``tables[<id>].counts``.
The host's waits for the card are counted by their ``sync.<site>`` spans.

``tables`` keeps every graph's table by graph id, also after the graph is
freed.  Reading a layer split from a trace: a host ``cudaGraphLaunch`` inside
``gymgo.graph.replay.<id>`` runs ``tables[<id>].ops`` device operations whose
layers are ``tables[<id>].paths()``; every other launch call runs one
operation under the spans open around it.  A graph that is not one chain of
nodes, or whose edges the driver cannot give, has ``chain`` false and no
``paths()``: its operations may run in another order than they were
captured.

This module imports nothing of the package, and torch only when it needs it.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import itertools
import sys

__all__ = ["PREFIX", "counters", "tables", "span", "sync", "count", "replayed", "capturing", "finish",
           "LayerTable", "layer_runs", "chain_order", "new_graph_id"]

PREFIX = "gymgo."
# process-wide counts (``count``), replays' captured counts included
counters: collections.Counter = collections.Counter()
# every captured graph's ``LayerTable`` by graph id
tables: dict = {}
_ids = itertools.count(1)
# the capture in progress, if any (``capturing``)
_capture = None
_OFF = contextlib.nullcontext()
# the card's device operations among libcuda's graph node types (kernel 0,
# memcpy 1, memset 2) and the letter of each kind in a table's ``kinds``
_OP_KINDS = {0: "k", 1: "c", 2: "s"}


def new_graph_id() -> int:
    """A process-unique graph id."""
    return next(_ids)


def _profiling() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        if _profiling():
            import torch

            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        if _capture is not None:
            _capture.enter(self.name)
        return self

    def __exit__(self, *exc):
        if _capture is not None:
            _capture.exit()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """The layer ``name`` around a block: a ``gymgo.<name>`` profiler range
    while a profiler runs, a boundary of the layer table while a graph is
    captured, else nothing."""
    if _capture is None and not _profiling():
        return _OFF
    return _Span(PREFIX + name)


def sync(site: str):
    """``span("sync.<site>")`` around a wait of the host for the card (a copy
    to the host, ``.item()``); the span's length is the wait."""
    return span("sync." + site)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``; inside a capture, to the graph's
    counts, which each replay adds."""
    if _capture is not None:
        _capture.counts[name] += n
    else:
        counters[name] += n


def replayed(table: "LayerTable") -> None:
    """Count what one replay of ``table``'s graph ran: its captured counts."""
    counters.update(table.counts)


@dataclasses.dataclass
class LayerTable:
    """The layers of one captured graph: ``nodes`` graph nodes, ``ops`` of
    them device operations; ``runs`` are ``(path, first, last)`` over the
    operations' positions in capture order (``last`` included), each path the
    spans open at the capture, ``/``-joined, outermost first; ``counts`` are
    the counts taken during the capture; ``chain`` says that every node has
    at most one dependency and one dependent, so a replay runs the
    operations in capture order; ``kinds`` has a letter for each operation
    in that order: ``k`` a kernel, ``c`` a copy, ``s`` a set."""

    graph_id: int
    nodes: int
    ops: int
    runs: list
    counts: dict
    chain: bool
    kinds: str = ""

    def paths(self) -> list | None:
        """The path of each device operation of a replay in the order the
        card runs them; None when the graph is not a chain."""
        if not self.chain:
            return None
        out = []
        for path, first, last in self.runs:
            out.extend([path] * (last - first + 1))
        return out


def layer_runs(marks, ops: int) -> list:
    """``(path, first, last)`` runs from ``marks``: ``(ops_before, path)`` in
    capture order, each the number of device operations captured before a
    span's entry or exit and the path open after it.  The operations from one
    mark to the next take the first mark's path; equal neighbouring paths
    merge, empty stretches vanish."""
    runs = []
    bounded = list(marks) + [(ops, None)]
    for (first, path), (end, _) in zip(bounded, bounded[1:]):
        if end <= first:
            continue
        if runs and runs[-1][0] == path:
            runs[-1] = (path, runs[-1][1], end - 1)
        else:
            runs.append((path, first, end - 1))
    return runs


class _Driver:
    """libcuda's graph and capture queries, by ctypes."""

    def __init__(self):
        lib = ctypes.CDLL("libcuda.so.1")
        # a driver without it leaves every table unusable, never the capture failed
        self.capture_info = getattr(lib, "cuStreamGetCaptureInfo_v2", None)
        self.get_nodes = lib.cuGraphGetNodes
        self.node_type = lib.cuGraphNodeGetType
        self.get_edges = lib.cuGraphGetEdges

    @staticmethod
    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what} failed: CUresult {err}")

    def frontier(self) -> tuple | None:
        """The nodes the next node captured on the current stream will
        depend on; None when the driver cannot say."""
        import torch

        if self.capture_info is None:
            return None
        stream = torch.cuda.current_stream().cuda_stream
        status, cid, graph = ctypes.c_int(0), ctypes.c_uint64(0), ctypes.c_void_p()
        deps, n = ctypes.POINTER(ctypes.c_void_p)(), ctypes.c_size_t(0)
        err = self.capture_info(ctypes.c_void_p(stream), ctypes.byref(status), ctypes.byref(cid),
                                ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(n))
        return None if err != 0 else tuple(deps[i] for i in range(n.value))

    def nodes(self, graph: int) -> list:
        n = ctypes.c_size_t(0)
        self.check(self.get_nodes(ctypes.c_void_p(graph), None, ctypes.byref(n)), "cuGraphGetNodes")
        buf = (ctypes.c_void_p * n.value)()
        self.check(self.get_nodes(ctypes.c_void_p(graph), buf, ctypes.byref(n)), "cuGraphGetNodes")
        return list(buf)

    def kind(self, node: int) -> str | None:
        """The node's kind of device operation (``_OP_KINDS``), None for a
        node that is none."""
        kind = ctypes.c_int(-1)
        self.check(self.node_type(ctypes.c_void_p(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        return _OP_KINDS.get(kind.value)

    def edges(self, graph: int) -> list | None:
        """The graph's dependencies ``(from, to)``; None when the driver
        cannot give them as such, as for edges that carry data
        (``CUDA_ERROR_LOSSY_QUERY``, which a training step's graph can
        hold): its table is then unusable, and the capture goes on."""
        n = ctypes.c_size_t(0)
        if self.get_edges(ctypes.c_void_p(graph), None, None, ctypes.byref(n)) != 0:
            return None
        src, dst = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
        if self.get_edges(ctypes.c_void_p(graph), src, dst, ctypes.byref(n)) != 0:
            return None
        return list(zip(src, dst))


_driver = None


def _lib() -> _Driver:
    global _driver
    if _driver is None:
        _driver = _Driver()
    return _driver


def chain_order(nodes: list, edges: list) -> list | None:
    """``nodes`` in dependency order when they form one chain (each at most
    one dependency and one dependent, one root, every node reached), else
    None."""
    nxt, has_dep = {}, set()
    for a, b in edges:
        if a in nxt or b in has_dep:
            return None
        nxt[a] = b
        has_dep.add(b)
    roots = [x for x in nodes if x not in has_dep]
    if len(roots) != (1 if nodes else 0):
        return None
    order = roots
    while order and order[-1] in nxt:
        order.append(nxt[order[-1]])
    return order if len(order) == len(nodes) else None


class _Capture:
    """The marks of one graph's capture: the open spans, and at each span's
    entry and exit the frontier of the capturing stream (None where the
    driver could not give it, which leaves the table unusable)."""

    def __init__(self, graph_id: int):
        self.graph_id = graph_id
        self.open: list = []
        self.marks: list = [((), "")]
        self.counts: collections.Counter = collections.Counter()

    def _mark(self):
        self.marks.append((_lib().frontier(), "/".join(self.open)))

    def enter(self, name: str):
        self.open.append(name)
        self._mark()

    def exit(self):
        self.open.pop()
        self._mark()

    def table(self, graph: int) -> LayerTable:
        """The table of the captured ``graph`` (its handle), from the marks."""
        drv = _lib()
        nodes, edges = drv.nodes(graph), drv.edges(graph)
        order = None if edges is None else chain_order(nodes, edges)
        chain = order is not None and all(front is not None and len(front) <= 1 for front, _ in self.marks)
        ops_through, kinds = {}, []
        for node in order if chain else nodes:
            kind = drv.kind(node)
            if kind is not None:
                kinds.append(kind)
            ops_through[node] = len(kinds)
        marks = [(ops_through[front[0]] if front else 0, path) for front, path in self.marks] if chain else []
        ops = len(kinds)
        return LayerTable(self.graph_id, len(nodes), ops, layer_runs(marks, ops), dict(self.counts), chain,
                          "".join(kinds) if chain else "")


@contextlib.contextmanager
def capturing(graph_id: int):
    """Within the block a CUDA graph is captured on the current stream: spans
    mark its layer table and counts go to the graph.  Yields the capture;
    ``finish(capture, graph)`` then builds and registers its table."""
    global _capture
    if _capture is not None:
        raise RuntimeError("a capture is in progress already")
    _capture = _Capture(graph_id)
    try:
        yield _capture
    finally:
        _capture = None


def finish(capture: _Capture, graph: int) -> LayerTable:
    """Build the layer table of ``capture`` from the captured ``graph`` (its
    handle) and register it in ``tables``."""
    table = capture.table(graph)
    tables[capture.graph_id] = table
    return table
