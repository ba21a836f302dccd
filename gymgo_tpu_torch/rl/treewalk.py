"""Batched tree descent for on-device search (counterpart of
``gymgo_tpu.rl.treewalk``).

Tree statistics are frozen during one selection walk, so the per-node argmax
action, its child pointer and its continue flag are computed for every node at
once over the ``(B, M, A)`` tree arrays (``node_tables``); the walk itself then
only chases pointers through ``(B, M)`` tables (``walk_paths``).  Semantics per
env: start at node 0, take the argmax edge, record it, continue while the
edge's child exists and is not terminal.

The JAX package reads these tables with one-hot masked reduces because a
gather is slow on its chip; here they are ``torch.gather`` and advanced
indexing, with the same values.
"""

from __future__ import annotations

import torch

__all__ = ["node_tables", "gather_edge", "gather_node", "forced_root_edge", "walk_paths"]


def _child_is_open(nxt: torch.Tensor, node_done: torch.Tensor) -> torch.Tensor:
    """``nxt >= 0`` and not ``node_done[b, nxt]``; ``nxt`` is (B,) or (B, M)."""
    idx = nxt.clamp_min(0).to(torch.int64)
    done = node_done.gather(1, idx.view(idx.shape[0], -1)).view(idx.shape)
    return (nxt >= 0) & ~done


def node_tables(scores: torch.Tensor, child: torch.Tensor, node_done: torch.Tensor):
    """Per-node descent tables from frozen tree statistics.

    Args:
      scores: float32 (B, M, A) selection scores, -inf on actions that cannot
        be selected.
      child: int32 (B, M, A) child pointers, -1 = unexpanded.
      node_done: bool (B, M) terminal flags.

    Returns:
      best_act: int32 (B, M) argmax action per node (the first of equals; 0
        for a row that is all -inf).
      nxt_tab: int32 (B, M) child reached by best_act (-1 = unexpanded).
      keep_tab: bool (B, M), the walk continues past this node (an expanded
        child that is not terminal).
    """
    best = scores.argmax(dim=-1)
    nxt_tab = child.gather(2, best[..., None])[..., 0]
    return best.to(torch.int32), nxt_tab, _child_is_open(nxt_tab, node_done)


def gather_edge(arr: torch.Tensor, parent: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """``arr[b, parent[b], action[b]]`` for (B, M, A) ``arr``."""
    bidx = torch.arange(arr.shape[0], device=arr.device)
    return arr[bidx, parent.to(torch.int64), action.to(torch.int64)]


def gather_node(arr: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """``arr[b, node[b]]`` for (B, M) ``arr``; ``node`` must be in range."""
    return arr.gather(1, node.to(torch.int64)[:, None])[:, 0]


def forced_root_edge(forced_act: torch.Tensor, child: torch.Tensor, node_done: torch.Tensor):
    """``(forced_nxt int32 (B,), forced_keep bool (B,))``: the child and the
    continue flag of a forced action at the root, for a search whose root
    action is dictated (sequential halving)."""
    forced_nxt = gather_node(child[:, 0], forced_act)
    return forced_nxt, _child_is_open(forced_nxt, node_done)


def walk_paths(best_act, nxt_tab, keep_tab, max_depth: int, forced_root=None):
    """Descend every env's tree from node 0 along the tables of ``node_tables``.

    Lanes stop on their own: an open lane's depth equals the iteration index,
    and a closed lane re-writes the -1 its path was filled with.  The loop ends
    at the deepest path: "is any lane open" is read on the host before every
    depth (one sync each), which on the card costs less than the launches of
    the depths no lane reaches.

    Args:
      max_depth: bound of the walk and width of the path arrays.
      forced_root: optional ``(act, nxt, keep)``, each (B,), overriding the
        depth-0 edge (from ``forced_root_edge``).

    Returns:
      depth: int32 (B,) path lengths (>= 1).
      path_n: int32 (B, max_depth) node indices (-1 past the path).
      path_a: int32 (B, max_depth) action indices (-1 past the path).
    """
    b = best_act.shape[0]
    dev = best_act.device
    node = torch.zeros((b,), dtype=torch.int64, device=dev)
    depth_b = torch.zeros((b,), dtype=torch.int32, device=dev)
    path_n = torch.full((b, max_depth), -1, dtype=torch.int32, device=dev)
    path_a = torch.full((b, max_depth), -1, dtype=torch.int32, device=dev)
    open_ = torch.ones((b,), dtype=torch.bool, device=dev)
    for depth in range(max_depth):
        if not bool(open_.any()):
            break
        if depth == 0 and forced_root is not None:
            act, nxt, keep = forced_root
        else:
            act, nxt, keep = (t.gather(1, node[:, None])[:, 0] for t in (best_act, nxt_tab, keep_tab))
        path_n[:, depth] = torch.where(open_, node, -1)
        path_a[:, depth] = torch.where(open_, act, -1)
        depth_b += open_
        node = torch.where(open_ & (nxt >= 0), nxt, node)
        open_ = open_ & keep
    return depth_b, path_n, path_a
