"""``lib/layers.py`` on synthetic traces: eager and replayed operations put
down to the spans that launched them, the records of the last operations
lost by the profiler, no answer where launches and operations do not pair
up, and the readers built on it."""

import pytest

from gymgo_tpu_torch.utils import tracing
from portbench import harness
from portbench.lib import layers
from portbench.lib.trace import DeviceTrace

GRAPH = 10 ** 9  # an id no graph of the process takes
REPLAY = f"gymgo.graph.replay.{GRAPH}"
STEP = ("portbench.rollout", REPLAY, "gymgo.env.step")


@pytest.fixture
def table():
    runs = [("gymgo.env.step", 0, 1), ("gymgo.env.step/gymgo.env.flood", 2, 2)]
    tracing.tables[GRAPH] = tracing.LayerTable(GRAPH, 4, 3, runs, {}, True, "kkk")
    yield tracing.tables[GRAPH]
    del tracing.tables[GRAPH]


def _trace(drop=None, add=None, units=2):
    host = [
        (100, 380, "portbench.rollout"),
        (110, 120, "cudaLaunchKernel"),
        (112, 118, "cuLaunchKernel"),  # the driver call of the runtime call: one operation
        (190, 195, "gymgo.graph.copy_in"),
        (200, 300, REPLAY),
        (210, 290, "cudaGraphLaunch"),
        (215, 216, "aten::empty"),
        (390, 600, "portbench.checksum"),
        (395, 500, "gymgo.sync.x"),
        (400, 410, "cudaMemcpyAsync"),
        (450, 460, "cudaStreamSynchronize"),
    ]
    ops = [(130, 150, "k0"), (305, 315, "a"), (320, 330, "b"), (340, 360, "c"), (420, 430, "Memcpy DtoH")]
    if drop is not None:
        ops.pop(drop)
    if add is not None:
        ops.append(add)
    # the device clock drifts from the host's: an operation may start past the section's end
    return DeviceTrace(ops, host, (50, 425), units)


def test_eager_and_replayed_operations_go_to_the_spans_that_launched_them(table):
    ops = layers.attribute(_trace())
    assert [(op.name, op.path, op.replay) for op in ops] == [
        ("k0", ("portbench.rollout",), None),
        ("a", STEP, 0), ("b", STEP, 0), ("c", STEP + ("gymgo.env.flood",), 0),
        ("Memcpy DtoH", ("portbench.checksum", "gymgo.sync.x"), None),
    ]
    t = _trace()
    assert layers.device_seconds(t, "env.step") == 40e-9
    assert layers.device_seconds(t, "env.step", own=True) == 20e-9
    assert layers.device_seconds(t, "env.flood") == 20e-9
    assert layers.device_seconds(t, "env.score") is None
    assert layers.replay_gaps(t) == 15e-9  # 315 -> 320 and 330 -> 340
    split = layers.report(t)
    assert split["program_s"] == 50e-9 and split["bench_only_s"] == 20e-9 and split["neither_s"] == 0
    assert split["idle_in_replays_s"] == 15e-9
    assert split["idle_s"] == pytest.approx(split["idle_in_replays_s"] + split["idle_between_replays_s"])
    assert split["lost_ops"] == layers.lost(t) == 0


def test_a_graphs_copy_the_driver_ran_as_its_own_kernel_is_still_a_copy(table):
    table.kinds = "kck"
    t = _trace()
    t.ops[2] = (320, 330, "memcpy32_post")
    assert [op.name for op in layers.attribute(t)][2] == "memcpy32_post"
    assert [layers._kind(n) for n in ("Memcpy DtoD (Device -> Device)", "memcpy32_post", "Memset (Device)",
                                      "cudaMemsetAsync", "cuMemcpyHtoDAsync_v2", "cudaLaunchKernel",
                                      "void at::native::direct_copy_kernel_cuda")] == list("ccssckk")


def test_the_records_the_profiler_lost_at_the_end_leave_their_launches_unpaired(table):
    t = _trace(drop=4)
    assert [op.name for op in layers.attribute(t)] == ["k0", "a", "b", "c"] and layers.lost(t) == 1
    assert layers.device_seconds(t, "env.flood") == 20e-9


@pytest.mark.parametrize("drop,add,kinds", [
    (2, None, "kkk"),  # an operation lost inside: the copy pairs with a kernel launch
    (None, (800, 810, "k9"), "kkk"),  # an operation no launch issued
    (None, None, "kck"),  # a replay's kinds that disagree with the trace's
], ids=["lost-inside", "extra", "kinds"])
def test_no_answer_when_launches_and_operations_do_not_pair_up(drop, add, kinds, table):
    table.kinds = kinds
    t = _trace(drop=drop, add=add)
    assert layers.attribute(t) is None and layers.device_seconds(t, "env.step") is None and layers.lost(t) is None


def test_no_answer_without_a_usable_table(table, monkeypatch):
    table.chain = False  # its operations may run in another order than captured
    assert layers.attribute(_trace()) is None
    table.chain = True
    monkeypatch.delitem(tracing.tables, GRAPH)  # a graph the program keeps no table of
    assert layers.attribute(_trace()) is None
    monkeypatch.setattr(layers, "_tables", lambda: None)  # a program without tracing
    assert layers.attribute(_trace()) is None


def test_host_self_time_leaves_out_graph_work_and_waits():
    host = [(0, 100, "gymgo.gtp.handle"), (5, 95, "gymgo.gtp.genmove"), (10, 30, REPLAY),
            (12, 20, "cudaGraphLaunch"), (50, 60, "gymgo.sync.mover"), (55, 58, "cudaMemcpyAsync"),
            (200, 240, "gymgo.gtp.handle"), (210, 220, "gymgo.sync.gogame.to_host"), (300, 310, "portbench.x")]
    t = DeviceTrace([], host, (0, 400), 2)
    got = layers.host_self_seconds(t, ("gymgo.gtp.", "gymgo.mover"), ("gymgo.graph.", "gymgo.sync."))
    assert got == pytest.approx((100 - 20 - 10 + 40 - 10) * 1e-9)
    assert layers.span_count(t, "gymgo.sync.") == 2
    assert layers.host_self_seconds(t, ("gymgo.nothing",), ("gymgo.sync.",)) is None


def test_a_sections_count_adds_each_replayed_graphs_captured_count(table):
    table.counts = {"search.net_rows": 6}
    t = _trace()
    assert layers.replayed_count(t, "search.net_rows", "search.net") == 6
    assert layers.replayed_count(t, "search.other", "search.net") == 0
    t.host.append((700, 900, REPLAY))  # past the section's end
    t.host.append((250, 260, REPLAY))
    assert layers.replayed_count(t, "search.net_rows", "search.net") == 12
    t.host.append((330, 340, "gymgo.search.net"))  # an eager evaluation: its count is in no table
    assert layers.replayed_count(t, "search.net_rows", "search.net") is None
    assert layers.replayed_count(None, "search.net_rows", "search.net") is None


def test_no_section_count_without_a_replayed_graphs_table(table, monkeypatch):
    monkeypatch.delitem(tracing.tables, GRAPH)
    assert layers.replayed_count(_trace(), "search.net_rows", "search.net") is None
    monkeypatch.setattr(layers, "_tables", lambda: None)
    assert layers.replayed_count(_trace(), "search.net_rows", "search.net") is None


def test_net_rows_per_move_divides_by_the_searched_roots(table):
    cell = harness.cell(harness.manifest(), "agz20.search_b256")
    batch = cell.traffic["batch"]
    table.counts = {"search.net_rows": 3 * batch}
    assert harness.reader("search_net_rows_per_move")(harness.Run(cell, 1.0, {}, _trace())) == 3 / 2
    table.counts = {}
    assert harness.reader("search_net_rows_per_move")(harness.Run(cell, 1.0, {}, _trace())) is None
    assert harness.reader("search_net_rows_per_move")(harness.Run(cell, 1.0, {}, None)) is None


@pytest.mark.parametrize("metric,value", [
    ("env_rules_us_per_step", None),  # no operation's innermost program span is env.rules
    ("env_flood_us_per_step", 20e-9 / 2 * 1e6),
    ("env_node_gap_us_per_step", 15e-9 / 2 * 1e6),
    ("genmove_syncs", 1 / 2),
])
def test_the_readers_take_the_split_per_unit(metric, value, table):
    cell = harness.cell(harness.manifest(), "go19.actor_b512")
    assert harness.reader(metric)(harness.Run(cell, 1.0, {}, _trace())) == value
    assert harness.reader(metric)(harness.Run(cell, 1.0, {}, None)) is None
