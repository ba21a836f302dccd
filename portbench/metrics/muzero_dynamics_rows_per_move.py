"""Boards ``g`` took per searched move in the traced searches: the program's
counter ``search.dynamics_rows`` over the section, from each replayed
search graph's captured count (``layers.replayed_count``), over the roots
searched.  One a simulation, the count ``muzero_mfu_pct`` takes its FLOPs
for; a reading above ``simulations`` is work that share leaves out."""

from portbench.lib import layers


def read(run):
    t = run.trace
    rows = layers.replayed_count(t, "search.dynamics_rows", "search.dynamics")
    if not rows or not t.units:
        return None
    return rows / (t.units * run.cell.traffic["batch"])
