"""Device time of a traced section by the program's layers.

The program names its layers by host spans ``gymgo.<layer>``
(``gymgo_tpu_torch.utils.tracing``) and keeps for each captured CUDA graph a
layer table: the span path of each device operation of a replay, in the
order the card runs them (``tracing.tables``).  ``attribute`` puts every
device operation of the section under a path of spans: the host's launch
calls, in time order, each issue one operation under the spans open around
the call (``cudaLaunchKernel``, ``cuLaunchKernel*``, ``cudaMemcpyAsync``,
``cudaMemsetAsync`` and their kin), and a ``cudaGraphLaunch`` inside
``gymgo.graph.replay.<id>`` issues the operations of graph ``<id>``'s table;
they pair with the device operations in start order, and each pair must
agree in kind (a kernel, a copy or a set; a table keeps its operations'
kinds).  The profiler may lose the records of the section's last
operations: their launches are left unpaired.  ``attribute`` returns None,
and so does every reader built on it, when the program keeps no tables (one
without ``utils.tracing``), when a graph's table is missing or its graph is
no chain, when there are more operations than launches issued, or when a
pair disagrees in kind: no guess.

Device operations are taken from the whole profile, not only those whose
start lies in the section's span: the profiler's device clock drifts from
the host's by up to tens of us over a section, and every operation of the
profile was launched inside the section.

A layer's time sums every operation with the layer's span anywhere on its
path, so a layer holds its children; ``own`` takes only those whose
innermost program span it is.
"""

from __future__ import annotations

import dataclasses

PROGRAM = "gymgo."
BENCH = "portbench."
REPLAY = "gymgo.graph.replay."
GRAPH_LAUNCH = "cudaGraphLaunch"
# host calls that issue one device operation each
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchCooperativeKernel",
            "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")


def _kind(name: str) -> str:
    """A device operation's or a launch call's kind: ``c`` a copy, ``s`` a
    set, ``k`` a kernel (the letters of a layer table's ``kinds``).  The
    driver may run a graph's copy or set node as a kernel of its own
    (``memcpy32_post``), which is still that node."""
    head = name.removeprefix("cuda").removeprefix("cu")[:6].lower()
    if head == "memcpy":
        return "c"
    if head == "memset":
        return "s"
    return "k"


@dataclasses.dataclass
class Op:
    """A device operation of the section: its interval, name, the span path
    it ran under (outermost first) and the replay it ran in (an index over
    the section's replays, None for an eager operation)."""

    start: int
    end: int
    name: str
    path: tuple
    replay: int | None


def _tables():
    try:
        from gymgo_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.tables


def _in_window(trace, events):
    lo, hi = trace.window
    return [e for e in events if lo <= e[0] <= hi]


def _launches(trace):
    """``(start, path, name)`` of every launch call of the section, its path
    the benchmark's and the program's spans open around it; a launch inside
    another (the driver call of a runtime call) is the outer one's."""
    host = sorted(_in_window(trace, trace.host), key=lambda h: (h[0], -h[1]))
    open_, out, reach = [], [], -1
    for start, end, name in host:
        while open_ and open_[-1][1] < end:
            open_.pop()
        if name.startswith((PROGRAM, BENCH)):
            open_.append((start, end, name))
        elif name == GRAPH_LAUNCH or name.startswith(LAUNCHES):
            if start >= reach:
                out.append((start, tuple(n for _, _, n in open_), name))
            reach = max(reach, end)
    return out


_memo: dict = {}


def _paired(trace):
    """``(ops, launched)``: ``attribute``'s list (or None) and the number of
    operations the section's launches issued."""
    if trace is None:
        return None, 0
    hit = _memo.get(id(trace))
    if hit is None or hit[0] is not trace:
        hit = _memo[id(trace)] = (trace,) + _attribute(trace)
    return hit[1], hit[2]


def attribute(trace) -> list | None:
    """Every device operation of the section as an ``Op`` in start order, or
    None (see the module docstring)."""
    return _paired(trace)[0]


def lost(trace) -> int | None:
    """Operations the section launched whose records the profiler lost at
    its end; None when the section cannot be attributed."""
    ops, launched = _paired(trace)
    return None if ops is None else launched - len(ops)


def _attribute(trace):
    tables = _tables()
    if tables is None:
        return None, 0
    issued, replays = [], 0
    for _, path, name in _launches(trace):
        if name != GRAPH_LAUNCH:
            issued.append((path, None, _kind(name)))
            continue
        ids = [n[len(REPLAY):] for n in path if n.startswith(REPLAY)]
        table = tables.get(int(ids[-1])) if ids and ids[-1].isdigit() else None
        paths = table.paths() if table is not None else None
        if paths is None or len(table.kinds) != len(paths):
            return None, 0
        issued.extend((path + tuple(p.split("/")) if p else path, replays, kind) for p, kind in zip(paths, table.kinds))
        replays += 1
    ops = sorted(op for op in trace.ops if not op[2].startswith(PROGRAM))
    if len(ops) > len(issued) or any(_kind(op[2]) != kind for op, (_, _, kind) in zip(ops, issued)):
        return None, len(issued)
    return [Op(start, end, name, path, replay) for (start, end, name), (path, replay, _) in zip(ops, issued)], len(issued)


def _innermost(path: tuple) -> str | None:
    program = [n for n in path if n.startswith(PROGRAM)]
    return program[-1] if program else None


def device_seconds(trace, *layers: str, own: bool = False) -> float | None:
    """Summed device time of the operations under any of ``layers`` (span
    names without the ``gymgo.`` prefix); with ``own``, of those whose
    innermost program span is one of them.  None when the section cannot
    be attributed or holds none."""
    ops = attribute(trace)
    if not ops:
        return None
    names = {PROGRAM + layer for layer in layers}
    if own:
        picked = [op for op in ops if _innermost(op.path) in names]
    else:
        picked = [op for op in ops if names.intersection(op.path)]
    if not picked:
        return None
    return sum(op.end - op.start for op in picked) / 1e9


def replay_gaps(trace) -> float | None:
    """Seconds the device stood idle inside replays: between the first and
    the last operation of each replay, the time no operation of it ran."""
    ops = attribute(trace)
    if not ops:
        return None
    by_replay: dict = {}
    for op in ops:
        if op.replay is not None:
            by_replay.setdefault(op.replay, []).append(op)
    if not by_replay:
        return None
    idle = 0
    for run in by_replay.values():
        reach = run[0].end
        for op in run[1:]:
            idle += max(0, op.start - reach)
            reach = max(reach, op.end)
    return idle / 1e9


def host_self_seconds(trace, outer: tuple, inner: tuple) -> float | None:
    """Host seconds inside the outermost spans whose names start with one of
    ``outer`` and outside every span whose name starts with one of
    ``inner``: the program's own host time in a layer, its graph work and
    its waits for the card taken out.  None when no such outer span ran."""
    host = sorted(_in_window(trace, trace.host), key=lambda h: (h[0], -h[1]))
    tops, reach = [], -1
    for start, end, name in host:
        if name.startswith(outer) and start >= reach:
            tops.append((start, end))
            reach = end
    if not tops:
        return None
    held = [(start, end) for start, end, name in host if name.startswith(inner)]
    total = 0
    for lo, hi in tops:
        edge = lo  # the time up to which the top span is accounted for
        for start, end in held:
            start, end = max(start, lo), min(end, hi)
            if end > max(start, edge):
                total += max(0, start - edge)
                edge = end
        total += hi - edge
    return total / 1e9


def replayed_count(trace, name: str, layer: str) -> int | None:
    """The program's counter ``name`` over the section: each
    ``gymgo.graph.replay.<id>`` span in it adds the count graph ``<id>``'s
    capture took (its table's ``counts``).  None when the program keeps no
    tables, when a replayed graph's table is missing, or when the layer
    ``layer`` (a span name without the ``gymgo.`` prefix) ran outside a graph
    in the section, as its counts there are in no table."""
    tables = _tables()
    if trace is None or tables is None:
        return None
    total = 0
    for _, _, span in _in_window(trace, trace.host):
        if span == PROGRAM + layer:
            return None
        if span.startswith(REPLAY):
            key = span[len(REPLAY):]
            table = tables.get(int(key)) if key.isdigit() else None
            if table is None:
                return None
            total += table.counts.get(name, 0)
    return total


def span_count(trace, prefix: str) -> int:
    """Host spans of the section whose name starts with ``prefix``."""
    return sum(1 for h in _in_window(trace, trace.host) if h[2].startswith(prefix))


def report(trace) -> dict | None:
    """The section's split for a reader of the trace: device seconds under a
    program span, under the benchmark's spans alone and under neither; idle
    seconds inside replays and between them; operations whose records the
    profiler lost."""
    ops = attribute(trace)
    if not ops:
        return None
    program = sum(op.end - op.start for op in ops if _innermost(op.path)) / 1e9
    bench = sum(op.end - op.start for op in ops if op.path and not _innermost(op.path)) / 1e9
    neither = sum(op.end - op.start for op in ops if not op.path) / 1e9
    idle = trace.window_s - trace.busy_s
    inside = replay_gaps(trace) or 0.0
    return {"device_s": program + bench + neither, "program_s": program, "bench_only_s": bench,
            "neither_s": neither, "idle_s": idle, "idle_in_replays_s": inside, "idle_between_replays_s": idle - inside,
            "lost_ops": lost(trace)}
