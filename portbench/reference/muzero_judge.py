"""The comparisons that decide ``correct`` in the learned-model cells: the
moves the timed path played against the plain rules (``go``), its root
choices and policies against the plain float32 network (``muzero``), and
its search trees node by node.  As ``judge.py``, nothing here reads the
program's code or state beyond the arrays it is handed, and every array it
judges is one the timed path produced; ``choice_gap``, ``logit_gap``,
``value_gap`` and the replay of the moves are ``judge.py``'s own.

A move is a dict as ``judge.judge_moves`` takes it (``root``, ``gumbel``,
``actions``, ``policy``, ``visits``, ``next``, ``reward``, ``done``,
``invalid``), with each game's tree: ``node_parent``, ``node_action`` (S,),
``node_value`` (S,) and ``node_logits`` (S, A) per game, slot 0 the root;
and, for the moves whose tree the judge rebuilds, ``latent_game`` (which
game) and ``latents``, that game's stored hidden states (S, C, N, N).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import go, judge, muzero

ROWS = 64  # boards a reference call takes at a time


def _blocks(fn, *arrays):
    """``fn`` over aligned leading rows of ``arrays`` in blocks of ``ROWS``,
    the results concatenated (a tuple of results concatenated each)."""
    outs = [fn(*(a[i:i + ROWS] for a in arrays)) for i in range(0, len(arrays[0]), ROWS)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def half_range(e: np.ndarray) -> np.ndarray:
    """Per row, (max - min) / 2: the row's error free of a constant, as the
    softmax of a row of logits is."""
    return (e.max(-1) - e.min(-1)) / 2


def tree_readings(w: dict, roots: np.ndarray, parent: np.ndarray, action: np.ndarray, value: np.ndarray,
                  logits: np.ndarray, latents: np.ndarray, device) -> dict:
    """Every node of each root's tree against one step of the reference from
    the program's own stored state of its parent, ``f(g(latents[parent],
    action))`` (the root's against ``f(h(root))``), so that the rounding of
    one level does not compound through the next levels' towers:
    ``node_value_gap``, the widest gap of a stored value, and
    ``node_logit_gap``, the widest half-range of a node's stored logits less
    the reference's."""
    q, s = parent.shape
    lat = torch.from_numpy(latents).to(device)
    rows = np.arange(q)
    ref_logits, ref_value = [], []
    for slot in range(s):
        if slot == 0:
            x = _blocks(lambda r: muzero.represent(w, r), torch.from_numpy(roots).to(device))
        else:
            up, acts = lat[rows, parent[:, slot]], torch.from_numpy(action[:, slot]).to(device)
            x = _blocks(lambda r, a: muzero.dynamics(w, r, a), up, acts)
        lg, v = _blocks(lambda r: muzero.predict(w, r), x)
        ref_logits.append(lg.double().cpu().numpy())
        ref_value.append(v.double().cpu().numpy())
    ref_logits, ref_value = np.stack(ref_logits, 1), np.stack(ref_value, 1)
    depth = np.zeros((q, s), np.int64)
    for slot in range(1, s):
        depth[:, slot] = depth[rows, parent[:, slot]] + 1
    return {"node_value_gap": float(np.abs(value.astype(np.float64) - ref_value).max()),
            "node_logit_gap": float(half_range(logits.astype(np.float64) - ref_logits).max()),
            "tree_nodes": int(q * s), "tree_depth": int(depth.max())}


def net_readings(w: dict, roots, legal, visits, policy, root_latents, komi: float, c_visit: float, c_scale: float,
                 device) -> dict:
    """The improved policies at ``roots`` against the reference, as
    ``judge.net_readings`` holds AZNet's: ``logit_gap`` over the legal
    actions the search did not visit (their completed q is the root's value,
    so log(pi) is the logits plus a constant), against ``f(h(root))``; and
    ``value_gap`` over those it visited once, whose completed q is the
    negated value of the child, here the reference's ``f(g(s, a))`` of the
    program's stored root state ``s`` (``root_latents``)."""
    with np.errstate(divide="ignore"):
        log_pi = np.log(policy.astype(np.float64))
    kept = legal & (policy >= judge._TINY)
    unvisited, once = kept & (visits == 0), kept & (visits == 1)
    sigma = (c_visit + visits.max(1, keepdims=True)) * c_scale
    s0 = _blocks(lambda x: muzero.represent(w, x), torch.from_numpy(roots).to(device))
    logits, values = (t.double().cpu().numpy() for t in _blocks(lambda x: muzero.predict(w, x), s0))
    rq, ra = np.nonzero(once)
    q = np.repeat(values[:, None], visits.shape[1], axis=1)
    if len(rq):
        up = torch.from_numpy(root_latents[rq]).to(device)
        child = _blocks(lambda x, a: muzero.dynamics(w, x, a), up, torch.from_numpy(ra).to(device))
        q[rq, ra] = -_blocks(lambda x: muzero.predict(w, x), child)[1].double().cpu().numpy()
    return {"logit_gap": judge.logit_gap(log_pi, logits, unvisited),
            "value_gap": judge.value_gap(log_pi, logits + sigma * q, once, sigma),
            "logit_roots": int((unvisited.sum(1) >= 2).sum()), "value_roots": int((once.sum(1) >= 2).sum())}


def judge_moves(segments: list, w: dict, traffic: dict, komi: float, method: str, device) -> dict:
    """Walk each segment's moves from its start boards, as
    ``judge.judge_moves`` does: ``mismatches``, ``illegal`` and
    ``choice_gap`` over every live root; ``logit_gap``, ``value_gap`` and
    the trees' ``node_value_gap`` and ``node_logit_gap`` over the live roots
    whose trees of hidden states the timed path kept (a move's ``latents``,
    of its sampled game ``latent_game``)."""
    mismatches, illegal = 0, 0
    keys = ("policy", "visits", "gumbel")
    tree_keys = ("policy", "visits", "node_parent", "node_action", "node_value", "node_logits")
    kept = {k: [] for k in ("legal", "picked") + keys}
    trees = {k: [] for k in ("root", "legal", "latents") + tree_keys}
    for b, moves in segments:
        for mv in moves:
            mismatches += int((b.to_states() != mv["root"]).any((1, 2, 3)).sum())
            live = ~b.done
            acts = np.asarray(mv["actions"], dtype=np.int64)
            legal = go.legal_actions(b)
            inside = (acts >= 0) & (acts < legal.shape[1])
            acts = np.where(inside, acts, legal.shape[1] - 1)
            illegal += int((live & ~(inside & legal[np.arange(len(acts)), acts])).sum())
            kept["legal"].append(legal[live])
            kept["picked"].append(acts[live])
            for k in keys:
                kept[k].append(np.asarray(mv[k])[live])
            if "latents" in mv and live[mv["latent_game"]]:
                i = mv["latent_game"]
                trees["root"].append(b.to_states()[i])
                trees["legal"].append(legal[i])
                trees["latents"].append(np.asarray(mv["latents"], dtype=np.float32))
                for k in tree_keys:
                    trees[k].append(np.asarray(mv[k])[i])
            b, st = go.step(go.reset_done(b), acts, komi, method)
            differs = (st.reward != mv["reward"]) | (st.done != mv["done"]) | (st.invalid != mv["invalid"])
            differs |= (b.to_states() != mv["next"]).any((1, 2, 3))
            mismatches += int(differs.sum())
    kept = {k: np.concatenate(v) for k, v in kept.items()}
    out = {"mismatches": mismatches, "illegal": illegal}
    with np.errstate(divide="ignore"):
        out["choice_gap"] = judge.choice_gap(kept["gumbel"].astype(np.float64),
                                             np.log(kept["policy"].astype(np.float64)), kept["visits"],
                                             kept["picked"])
    at = {k: np.stack(v) for k, v in trees.items()}
    out.update(net_readings(w, at["root"], at["legal"], at["visits"], at["policy"], at["latents"][:, 0], komi,
                            traffic["c_visit"], traffic["c_scale"], device))
    out.update(tree_readings(w, at["root"], at["node_parent"].astype(np.int64), at["node_action"].astype(np.int64),
                             at["node_value"], at["node_logits"], at["latents"], device))
    return out


def search_chain(setup_windows: list, moves: list, w: dict, traffic: dict, komi: float, method: str) -> dict:
    """Judge the learned-search cell for its sampled games from the empty
    board: the set-up's random windows (``judge.replay``), then every move
    the search chose, stepped by the env (``judge_moves``)."""
    s, n = setup_windows[0]["start"].shape[0], setup_windows[0]["start"].shape[-1]
    b = go.Boards.empty(s, n)
    mismatches = 0
    for wdw in setup_windows:
        mismatches += int((b.to_states() != wdw["start"]).any((1, 2, 3)).sum())
        b, bad, _ = judge.replay(b, wdw["actions"], komi, method, program=wdw)
        mismatches += bad
    device = next(iter(w.values())).device
    out = judge_moves([(b, moves)], w, traffic, komi, method, device)
    out["mismatches"] += mismatches
    return out
