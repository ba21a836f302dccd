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


def walk_paths(best_act, nxt_tab, keep_tab, max_depth: int, forced_root=None, depth_bound: int | None = None):
    """Descend every env's tree from node 0 along the tables of ``node_tables``.

    The JAX walk is a ``lax.while_loop`` whose condition (a lane is open and
    the depth is below ``max_depth``) is read on the device.  This one runs a
    fixed ``depth_bound`` iterations and reads nothing on the host, so a CUDA
    graph can hold it: an open lane's depth equals the iteration index, and a
    closed lane re-writes the -1 its path was filled with, so the iterations
    past the deepest path change no output.

    ``depth_bound`` (static, ``max_depth`` unless given) must be at least the
    longest path.  A child's slot always exceeds its parent's (each
    expansion takes the next free slot, and ``rl.mcts.compact_subtree`` keeps
    the old order), so a path visits strictly increasing slots and is no
    longer than the number of slots filled so far: a caller passes that
    count (``sim + 1`` in Gumbel search, ``R + wave * K`` in PUCT).

    Args:
      max_depth: width of the path arrays.
      forced_root: optional ``(act, nxt, keep)``, each (B,), overriding the
        depth-0 edge (from ``forced_root_edge``).
      depth_bound: the iterations run, at most ``max_depth``.

    Returns:
      depth: int32 (B,) path lengths (>= 1).
      path_n: int32 (B, max_depth) node indices (-1 past the path).
      path_a: int32 (B, max_depth) action indices (-1 past the path).
    """
    bound = max_depth if depth_bound is None else depth_bound
    if not 1 <= bound <= max_depth:
        raise ValueError(f"depth_bound {depth_bound} must lie in [1, max_depth={max_depth}]")
    b = best_act.shape[0]
    dev = best_act.device
    # one gather a depth: the argmax action and, where the walk goes on, the
    # child (-1 where it stops)
    tab = torch.stack((best_act, torch.where(keep_tab, nxt_tab, -1)), dim=-1)
    node = torch.zeros((b,), dtype=torch.int64, device=dev)
    open_ = torch.ones((b,), dtype=torch.bool, device=dev)
    cols_n, cols_a = [], []
    for depth in range(bound):
        if depth == 0 and forced_root is not None:
            act, nxt, keep = forced_root
            nxt = torch.where(keep, nxt, -1)
        else:
            act, nxt = tab.gather(1, node[:, None, None].expand(b, 1, 2))[:, 0].unbind(1)
        cols_n.append(torch.where(open_, node, -1))
        cols_a.append(torch.where(open_, act, -1))
        open_ = open_ & (nxt >= 0)
        node = torch.where(open_, nxt, node)
    path_n = torch.full((b, max_depth), -1, dtype=torch.int32, device=dev)
    path_a = torch.full((b, max_depth), -1, dtype=torch.int32, device=dev)
    path_n[:, :bound] = torch.stack(cols_n, dim=1)
    path_a[:, :bound] = torch.stack(cols_a, dim=1)
    return (path_n >= 0).sum(dim=1, dtype=torch.int32), path_n, path_a
