"""Boards the network evaluated per searched move in the traced searches:
the program's counter ``search.net_rows`` over the section, from each
replayed search graph's captured count (``layers.replayed_count``).  A
Gumbel search evaluates its root and one leaf a simulation, the
``1 + simulations`` that ``search_mfu_pct`` counts FLOPs for
(``counts.search_evaluations``); a reading above it is work that share
leaves out."""

from portbench.lib import layers


def read(run):
    t = run.trace
    rows = layers.replayed_count(t, "search.net_rows", "search.net")
    if not rows or not t.units:
        return None
    return rows / (t.units * run.cell.traffic["batch"])
