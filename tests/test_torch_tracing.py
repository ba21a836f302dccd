"""The port's layer spans and counters (``utils.tracing``): nothing made with
the profiler off, spans nested as their layer paths say under
``torch.profiler`` on the CPU, layer tables from a capture's marks, captured
counts added on each replay, and on a card (``cuda``) each graph's table
against the operations one replay runs.  Imports no JAX."""

import numpy as np
import pytest
import torch

from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core.state import batch_init_state
from gymgo_tpu_torch.env.batch_env import BatchGoEnv, rollout
from gymgo_tpu_torch.models.az_net import AZNetConfig, init_params
from gymgo_tpu_torch.rl import gumbel_mcts
from gymgo_tpu_torch.utils import graphs, tracing
from gymgo_tpu_torch.utils.gtp import GTPEngine, GumbelMover


def _events(block):
    """``(start_ns, end_ns, name)`` of the ``gymgo.*`` host spans the
    profiler records around ``block()``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        block()
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PREFIX):
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    return sorted(out, key=lambda h: (h[0], -h[1]))


def _paths(events) -> set:
    """Each span's path: the names of the spans around it, outermost first,
    ``/``-joined, without the prefix."""
    paths, open_ = set(), []
    for start, end, name in events:
        while open_ and open_[-1][1] < end:
            open_.pop()
        open_.append((start, end, name))
        paths.add("/".join(n[len(tracing.PREFIX):] for _, _, n in open_))
    return paths


def test_a_span_records_nothing_and_makes_no_range_with_the_profiler_off(monkeypatch):
    made = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function", lambda *a: made.append(a))
    assert not torch.autograd._profiler_enabled() and tracing._capture is None
    with tracing.span("env.step") as inside:
        assert inside is None
    with tracing.sync("gogame.to_host"):
        pass
    assert tracing.span("search.net") is tracing.span("env.rules") and made == []


def _rollout_on_the_cpu():
    cfg = EnvConfig(board_size=5, batch_size=4, auto_reset=True)
    rollout(torch.Generator().manual_seed(0), batch_init_state(4, 5, device="cpu"), 3, cfg)


def _net(n):
    return init_params(torch.Generator().manual_seed(0),
                       AZNetConfig(board_size=n, channels=8, blocks=1, dtype=torch.float32))


def _search_on_the_cpu():
    states = batch_init_state(2, 5, device="cpu")
    gumbel_mcts.run_gumbel_mcts(torch.Generator().manual_seed(1), states, _net(5), num_simulations=4,
                                max_considered=4)


def _genmove_on_the_cpu():
    engine = GTPEngine(board_size=5, komi=7.5, backend="torch", device="cpu",
                       genmove_fn=GumbelMover(_net(5), simulations=4, komi=7.5))
    assert engine.handle("genmove b")[0].startswith("=")


@pytest.mark.parametrize("block,want", [
    (_rollout_on_the_cpu, {"env.reset", "env.sampler", "env.step/env.sampler", "env.step/env.rules/env.flood",
                           "env.step/env.rules/env.score", "env.step/env.score", "env.flood"}),
    (_search_on_the_cpu, {"search.net", "search.root", "search.walk", "search.expand/env.rules/env.flood",
                          "search.expand/env.rules/env.score", "search.backup"}),
    (_genmove_on_the_cpu, {"gtp.handle/gtp.genmove/mover/search.net",
                           "gtp.handle/gtp.genmove/mover/search.expand/env.rules/env.flood",
                           "gtp.handle/gtp.genmove/mover/sync.mover",
                           "gtp.handle/gtp.genmove/sync.gogame.step_checked",
                           "gtp.handle/gtp.genmove/sync.gogame.to_host"}),
], ids=["rollout", "search", "genmove"])
def test_spans_nest_under_the_profiler_as_their_layer_paths_say(block, want):
    events = _events(block)
    assert events, "no gymgo span recorded"
    paths = _paths(events)
    assert want <= paths, sorted(want - paths)


@pytest.mark.parametrize("marks,ops,runs", [
    ([(0, "")], 4, [("", 0, 3)]),
    # entry of a, entry of a/b, exit of b, exit of a: each stretch takes the path open after its mark
    ([(0, ""), (1, "a"), (3, "a/b"), (5, "a"), (6, "")], 8,
     [("", 0, 0), ("a", 1, 2), ("a/b", 3, 4), ("a", 5, 5), ("", 6, 7)]),
    # spans that captured nothing leave no run, and equal neighbours merge
    ([(0, ""), (0, "a"), (0, ""), (2, "b"), (2, ""), (2, "b"), (4, "")], 4, [("", 0, 1), ("b", 2, 3)]),
    ([(0, ""), (0, "a"), (0, "")], 0, []),
], ids=["one-run", "nested", "empty-and-merged", "no-ops"])
def test_the_layer_table_builder_turns_marks_into_runs(marks, ops, runs):
    assert tracing.layer_runs(marks, ops) == runs
    table = tracing.LayerTable(0, ops, ops, runs, {}, True)
    assert len(table.paths()) == ops and (ops == 0 or table.paths()[-1] == runs[-1][0])
    assert tracing.LayerTable(0, ops, ops, runs, {}, False).paths() is None


@pytest.mark.parametrize("edges,order", [
    ([("a", "b"), ("b", "c")], ["a", "b", "c"]),
    ([("c", "a"), ("a", "b")], ["c", "a", "b"]),
    ([("a", "b"), ("a", "c")], None),  # a fork
    ([("a", "c"), ("b", "c")], None),  # a join: c has two dependencies
    ([("a", "b")], None),  # c stands apart
])
def test_a_graph_is_a_chain_only_when_every_node_has_one_dependency_and_dependent(edges, order):
    assert tracing.chain_order(["a", "b", "c"], edges) == order


@pytest.mark.parametrize("edges,chain", [
    ([("a", "b"), ("b", "c")], True),
    (None, False),  # the driver cannot give the edges (they carry data): the table is unusable
], ids=["chain", "edges-unknown"])
def test_a_captures_table_is_unusable_when_the_driver_cannot_give_its_edges(edges, chain, monkeypatch):
    class Driver:  # libcuda's answers for a graph of nodes a, b, c: two kernels and a memset
        def nodes(self, graph):
            return ["a", "b", "c"]

        def edges(self, graph):
            return edges

        def kind(self, node):
            return {"a": "k", "b": "k", "c": "s"}[node]

        def frontier(self):
            return (("a",), ("b",), ("c",))[len(capture.marks) - 1]

    monkeypatch.setattr(tracing, "_driver", Driver())
    capture = tracing._Capture(tracing.new_graph_id())
    capture.enter("env.step")
    capture.exit()
    table = tracing.finish(capture, 0)
    try:
        assert (table.nodes, table.ops, table.chain) == (3, 3, chain)
        # a was captured before the span opened, b inside it, c after it closed
        assert table.paths() == (["", "env.step", ""] if chain else None)
        assert table.kinds == ("kks" if chain else "")
    finally:
        del tracing.tables[table.graph_id]


def test_captured_counts_are_added_again_on_each_replay():
    before = tracing.counters.copy()
    with tracing.capturing(tracing.new_graph_id()) as capture:
        tracing.count("launches.k")
        tracing.count("search.net_rows", 5)
    assert tracing.counters == before and capture.counts == {"launches.k": 1, "search.net_rows": 5}
    assert tracing._capture is None

    class Graph:  # a replay runs no Python of the captured function
        def replay(self):
            pass

    table = tracing.LayerTable(capture.graph_id, 3, 2, [("gymgo.search.net", 0, 1)], dict(capture.counts), True)
    captured = graphs.CapturedGraph(Graph(), [torch.zeros(4, dtype=torch.int32)], torch.ones(2), table, 0.0)
    for _ in range(3):
        captured.replay([torch.ones(4, dtype=torch.int32)])
    grew = tracing.counters - before
    assert grew == {"launches.k": 3, "search.net_rows": 15}
    assert captured.span == f"graph.replay.{capture.graph_id}" and captured.replays == 3


@pytest.mark.parametrize("ops,split", [
    ([(10, 20)], (10, 0)),
    ([(30, 35), (10, 20), (22, 28)], (21, 4)),  # taken in start order: 20 -> 22 and 28 -> 30 idle
    ([(10, 40), (15, 20), (45, 50)], (40, 5)),  # an operation inside another leaves no idle
    ([], (0, 0)),
], ids=["one", "unordered", "overlapping", "none"])
def test_replay_gaps_splits_a_replay_into_its_operations_time_and_the_idle_between(ops, split):
    from gymgo_tpu_torch.scripts import replay_gaps

    assert replay_gaps.replay_split(ops) == split


# ---------------------------------------------------------------- on a card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _replay_ops(replay) -> int:
    """The number of device operations the one ``cudaGraphLaunch`` of
    ``replay()`` runs (found by the launch's correlation id)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    launches = [e.correlation_id() for e in events if e.name() == "cudaGraphLaunch"]
    assert len(launches) == 1, launches
    return sum(1 for e in events if e.device_type() == DeviceType.CUDA and e.correlation_id() == launches[0]
               and not (e.is_user_annotation() or e.name().startswith(tracing.PREFIX)))


def _rollout_graph(dev):
    env = BatchGoEnv(EnvConfig(board_size=19, batch_size=64, auto_reset=True), device=dev)
    gen, states = env.generator(0), env.reset()
    env.rollout(gen, states, 8)
    return env._rollout, lambda: env.rollout(gen, states, 8)


def _search_graph(dev):
    net = init_params(torch.Generator().manual_seed(0), AZNetConfig(board_size=19, channels=32, blocks=2)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    states = BatchGoEnv(EnvConfig(board_size=19, batch_size=4), device=dev).reset()
    gumbel_mcts.run_gumbel_mcts(gen, states, net, num_simulations=8)
    return gumbel_mcts.run_gumbel_mcts, lambda: gumbel_mcts.run_gumbel_mcts(gen, states, net, num_simulations=8)


def _gogame_graph(dev):
    from gymgo_tpu_torch import gogame

    state = np.zeros((6, 19, 19))
    gogame.next_state(state, 60, device=dev)
    return gogame._step_states, lambda: gogame.next_state(state, 60, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_rollout_graph, _search_graph, _gogame_graph], ids=["rollout", "search", "gogame"])
def test_a_graphs_table_covers_every_operation_of_one_replay_and_the_graph_is_a_chain(make, cuda_device):
    compiled_fn, replay = make(cuda_device)
    replays = {key: g.replays for key, g in compiled_fn.graphs.items()}
    ops = _replay_ops(replay)
    table = next(g for key, g in compiled_fn.graphs.items() if g.replays != replays.get(key)).table
    assert table.chain and tracing.tables[table.graph_id] is table
    assert table.runs[0][1] == 0 and table.runs[-1][2] == table.ops - 1
    assert all(a[2] + 1 == b[1] for a, b in zip(table.runs, table.runs[1:]))
    assert table.nodes >= table.ops > 0 and any("gymgo." in path for path, _, _ in table.runs)
    assert ops == table.ops
