"""The comparisons that decide ``correct``: what the timed path produced,
moved to the host, against the plain rules (``go``) and the plain float32
network (``aznet``).  Nothing here reads the program's code or state beyond
the arrays it is handed, and every array it judges is one the timed path
produced.

Each judge returns readings by name; the harness holds each against its
limit (``portbench/limits/<cell>.json``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import aznet, go

# an improved-policy entry below float32's least normal number has lost digits to underflow
_TINY = float(np.finfo(np.float32).tiny)


def replay(start: go.Boards, actions, komi: float, method: str, program: dict):
    """Play ``actions`` (T, S) from ``start`` with auto-reset.  Returns the
    final boards, the mismatches against ``program`` (a dict of the timed
    path's ``rewards``, ``dones``, ``invalid`` (T, S) and ``final`` states)
    counted per game and step, and each legal move's rank among the legal
    moves as a share in (0, 1) (``go.rank_of``; (rank + 1/2) / legal)."""
    b = start
    mismatches = 0
    shares = []
    for t, acts in enumerate(np.asarray(actions, dtype=np.int64)):
        b = go.reset_done(b)
        legal = go.legal_actions(b)
        inside = (acts >= 0) & (acts < legal.shape[1])
        ok = inside & legal[np.arange(len(acts)), np.where(inside, acts, 0)]
        ranks = go.rank_of(legal, np.where(ok, acts, 0))
        shares.append(((ranks + 0.5) / legal.sum(1))[ok])
        b, out = go.step(b, acts, komi, method)
        differs = ((out.reward != program["rewards"][t]) | (out.done != program["dones"][t])
                   | (out.invalid != program["invalid"][t]))
        mismatches += int(differs.sum())
    mismatches += int((b.to_states() != program["final"]).any((1, 2, 3)).sum())
    return b, mismatches, np.concatenate(shares) if shares else np.zeros(0)


def env_windows(windows: list, komi: float, method: str) -> dict:
    """Replay each recorded window of the env cells from its start.

    A window is a dict of ``start`` (S, 6, N, N) int8, ``actions``,
    ``rewards``, ``dones``, ``invalid`` (T, S) and ``final`` (S, 6, N, N),
    with ``from_empty`` true for the first window of the run (its start is
    the empty board, which the reference knows).  A later window starts from
    the state the program handed over, which the reference takes after
    checking that a game can reach it (``go.handed_over_faults``).

    Readings: ``mismatches`` (games and steps that differ, and states no game
    reaches) and ``rank_bias``, |mean rank share - 1/2| of the sampled moves:
    0 up to sampling noise for a uniform draw over the legal moves."""
    mismatches, shares = 0, []
    for w in windows:
        s, n = w["start"].shape[0], w["start"].shape[-1]
        if w["from_empty"]:
            start = go.Boards.empty(s, n)
            mismatches += int((w["start"] != 0).any((1, 2, 3)).sum())
        else:
            start = go.Boards.from_states(w["start"])
            mismatches += int(go.handed_over_faults(start).sum())
        _, bad, u = replay(start, w["actions"], komi, method, program=w)
        mismatches += bad
        shares.append(u)
    u = np.concatenate(shares)
    return {"mismatches": mismatches, "rank_bias": abs(float(u.mean()) - 0.5) if len(u) else math.inf}


def choice_gap(gumbel, log_pi, visits, actions) -> float:
    """The widest gap by which a chosen root action's score g + log(pi) lies
    below the best visited candidate's.  Gumbel search picks the visited
    candidate of the highest g + logits + sigma(completed q), and the improved
    policy's log is that score less g and a constant a root, so the gap is 0
    to rounding; an action that was not visited reads infinite."""
    score = np.where(visits > 0, gumbel + log_pi, -np.inf)
    rows = np.arange(len(actions))
    chosen = score[rows, actions]
    gaps = score.max(1) - chosen
    return float(np.where(np.isfinite(chosen), gaps, np.inf).max()) if len(rows) else 0.0


def logit_gap(log_pi: np.ndarray, reference: np.ndarray, include: np.ndarray) -> float:
    """The widest half-range, over a root's included actions, of log(pi)
    less the reference's logits.  At a root, Gumbel search's improved policy
    is softmax(logits + sigma(completed q)), and an action it did not visit
    takes the root's value as its completed q, so over the unvisited actions
    log(pi) is the program's logits plus one constant: the half-range is the
    program's error in logits, free of that constant."""
    e = np.where(include, log_pi - reference, np.nan)
    counted = include.sum(1) >= 2
    if not counted.any():
        return 0.0
    e = e[counted]
    return float(((np.nanmax(e, 1) - np.nanmin(e, 1)) / 2).max())


def _improved(w, roots, visits, children, once, komi, sigma):
    """Logits at ``roots`` and the improved logits logits + sigma * completed
    q that a search makes of them: the root's value for an unvisited action,
    the negated value of the child (its outcome where the game ends there)
    for an action visited once (``once``); other entries are left at the
    logits.  Both float64 ``(Q, A)``."""
    states = torch.from_numpy(np.concatenate([roots, children.to_states()]))
    logits, values = (t.double().cpu().numpy() for t in aznet.forward_blocks(w, states))
    q_roots = len(roots)
    ba, wa = go.areas(children.black, children.white)
    win_black = np.sign(ba - wa - komi)
    leaf = np.where(children.done, np.where(children.white_to_move, -win_black, win_black), values[q_roots:])
    q = np.repeat(values[:q_roots, None], visits.shape[1], axis=1)
    q[once] = -leaf
    return logits[:q_roots], logits[:q_roots] + sigma * q


def value_gap(log_pi, improved, once, sigma) -> float:
    """The widest half-range, over a root's actions visited once, of log(pi)
    less the reference's improved logits, over sigma: there the improved
    logit is logits + sigma * (the negated value of the child), so this is
    the program's error in the children's values (in value units, to the
    logits' error over sigma), free of the softmax's constant."""
    e = np.where(once, (log_pi - improved) / sigma, np.nan)
    counted = once.sum(1) >= 2
    if not counted.any():
        return 0.0
    e = e[counted]
    return float(((np.nanmax(e, 1) - np.nanmin(e, 1)) / 2).max())


def net_readings(w: dict, roots, legal, visits, policy, komi: float, c_visit: float, c_scale: float) -> dict:
    """The program's improved policies at ``roots`` (the reference's own
    states) against the float32 reference: ``logit_gap`` over the legal
    actions the search did not visit and ``value_gap`` over those it visited
    once, each where the policy entry keeps its digits."""
    with np.errstate(divide="ignore"):
        log_pi = np.log(policy.astype(np.float64))
    kept = legal & (policy >= _TINY)
    unvisited, once = kept & (visits == 0), kept & (visits == 1)
    sigma = (c_visit + visits.max(1, keepdims=True)) * c_scale
    rq, ra = np.nonzero(once)
    children, _ = go.step(go.Boards.from_states(roots[rq]), ra, komi, go.REAL)
    logits, improved = _improved(w, roots, visits, children, once, komi, sigma)
    out = {"logit_gap": logit_gap(log_pi, logits, unvisited), "value_gap": value_gap(log_pi, improved, once, sigma),
           "logit_roots": int((unvisited.sum(1) >= 2).sum()), "value_roots": int((once.sum(1) >= 2).sum())}
    return out


def search_chain(setup_windows: list, moves: list, w: dict, traffic: dict, komi: float, method: str,
                 rng: np.random.Generator) -> dict:
    """Judge the batched-search cell for its sampled games, from the empty
    board: the set-up's random windows (dicts as in ``env_windows``, one
    after the other), then every move the search chose, stepped by the env
    (``judge_moves``)."""
    s, n = setup_windows[0]["start"].shape[0], setup_windows[0]["start"].shape[-1]
    b = go.Boards.empty(s, n)
    mismatches = 0
    for wdw in setup_windows:
        mismatches += int((b.to_states() != wdw["start"]).any((1, 2, 3)).sum())
        b, bad, _ = replay(b, wdw["actions"], komi, method, program=wdw)
        mismatches += bad
    out = judge_moves([(b, moves)], w, traffic, komi, method, rng)
    out["mismatches"] += mismatches
    return out


def judge_moves(segments: list, w: dict, traffic: dict, komi: float, method: str, rng: np.random.Generator) -> dict:
    """Walk each segment's moves from its start boards (``go.Boards``).

    A move is a dict of the games' ``root`` states (S, 6, N, N) as the search
    got them, its root noise ``gumbel`` and its ``actions``, ``policy``
    (improved policy) and ``visits`` (root visits); then either the env
    step's ``next`` states, ``reward``, ``done``, ``invalid``, or the move the
    front end ``reply``-ed.  A finished root is reset before its move, as the
    env's auto-reset does, and judged only there.

    Readings: ``mismatches`` (states, rewards, flags or replies that differ),
    ``illegal`` (chosen moves the rules forbid), ``choice_gap`` over every
    live root, and ``logit_gap`` and ``value_gap`` over ``traffic["net_roots"]``
    live roots drawn from ``rng``."""
    mismatches, illegal = 0, 0
    roots, legal_at, picked, pol, vis, gum = [], [], [], [], [], []
    for b, moves in segments:
        for mv in moves:
            mismatches += int((b.to_states() != mv["root"]).any((1, 2, 3)).sum())
            live = ~b.done
            acts = np.asarray(mv["actions"], dtype=np.int64)
            legal = go.legal_actions(b)
            inside = (acts >= 0) & (acts < legal.shape[1])
            acts = np.where(inside, acts, legal.shape[1] - 1)
            allowed = inside & legal[np.arange(len(acts)), acts]
            illegal += int((live & ~allowed).sum())
            if "reply" in mv:
                mismatches += int((np.asarray(mv["reply"]) != acts).sum())
            roots.append(b.to_states()[live])
            legal_at.append(legal[live])
            picked.append(acts[live])
            pol.append(np.asarray(mv["policy"])[live])
            vis.append(np.asarray(mv["visits"])[live])
            gum.append(np.asarray(mv["gumbel"], dtype=np.float64)[live])
            b, st = go.step(go.reset_done(b), acts, komi, method)
            if "next" in mv:
                differs = (st.reward != mv["reward"]) | (st.done != mv["done"]) | (st.invalid != mv["invalid"])
                differs |= (b.to_states() != mv["next"]).any((1, 2, 3))
                mismatches += int(differs.sum())
    roots, legal_at = np.concatenate(roots), np.concatenate(legal_at)
    picked, pol, vis, gum = np.concatenate(picked), np.concatenate(pol), np.concatenate(vis), np.concatenate(gum)
    out = {"mismatches": mismatches, "illegal": illegal}
    with np.errstate(divide="ignore"):
        out["choice_gap"] = choice_gap(gum, np.log(pol.astype(np.float64)), vis, picked)
    pick = np.sort(rng.choice(len(roots), size=min(traffic["net_roots"], len(roots)), replace=False))
    out.update(net_readings(w, roots[pick], legal_at[pick], vis[pick], pol[pick], traffic["komi"],
                            traffic["c_visit"], traffic["c_scale"]))
    return out
