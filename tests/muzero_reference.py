"""Plain float32 reference of MuZero's Go network and of Gumbel MuZero's
search, in PyTorch, independent of the port: it imports no JAX and nothing
of ``gymgo_tpu_torch``.

The network (Schrittwieser et al. 2020, arXiv:1911.08265, Appendices E and
F), over weights handed in as a dict of tensors under ``MuZeroNet``'s
parameter names:

* ``represent``, ``h``: a 3x3 convolution of the canonical input planes to
  ``channels``, GroupNorm and relu, residual blocks of two 3x3 convolutions
  (each normed, relu between, the input added before the last relu), then
  ``scale``;
* ``dynamics``, ``g``: the same tower over the hidden state with one more
  plane, 1 at the stone the action plays (all zero for a pass), then
  ``scale``;
* ``predict``, ``f``: AlphaZero's heads, a policy of N*N + 1 logits and a
  tanh value.

``scale`` maps each board's values onto [0, 1] by its own minimum and range.
``search`` is one root's Gumbel MuZero search (Danihelka et al. 2022,
"Policy improvement by planning with Gumbel"): Gumbel-top-k root candidates,
sequential halving, the deterministic completed-Q rule inside the tree, one
``g`` and one ``f`` a simulation, a dict per node and Python loops.

Departures from the paper, each also the port's: GroupNorm (8 groups, eps
1e-6) where the paper has BatchNorm, and no norm in the heads; the
environment's 6 input planes for the paper's 17; the pass as an all-zero
action plane; no reward head (terminal reward only, discount 1: values back
up with one sign flip a ply); ``scale``'s range clamped to at least 1e-5;
Gumbel search in place of the paper's PUCT.  TF32 is switched off, so
convolutions and matrix products run in float32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

GROUPS = 8
EPS = 1e-6
SCALE_EPS = 1e-5


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def canonical(states: torch.Tensor) -> torch.Tensor:
    """float32 planes of int8 states ``(B, 6, N, N)`` from the mover's view:
    for white to move the colour planes swap and the turn plane flips."""
    x = states.to(torch.float32)
    swapped = torch.cat([x[:, 1:2], x[:, 0:1], 1 - x[:, 2:3], x[:, 3:]], dim=1)
    white = (x[:, 2, 0, 0] != 0)[:, None, None, None]
    return torch.where(white, swapped, x)


def scale(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    return (x - lo) / (hi - lo).clamp_min(SCALE_EPS)


def _tower(w: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
    blocks = sum(1 for k in w if k.startswith(prefix + ".blocks.") and k.endswith(".conv_0.weight"))

    def conv(x, name):
        return F.conv2d(x, w[f"{prefix}.{name}.weight"], padding=1)

    def norm(x, name):
        return F.group_norm(x, GROUPS, w[f"{prefix}.{name}.weight"], w[f"{prefix}.{name}.bias"], EPS)

    x = F.relu(norm(conv(x, "stem"), "stem_norm"))
    for i in range(blocks):
        h = F.relu(norm(conv(x, f"blocks.{i}.conv_0"), f"blocks.{i}.norm_0"))
        h = norm(conv(h, f"blocks.{i}.conv_1"), f"blocks.{i}.norm_1")
        x = F.relu(x + h)
    return x


@torch.no_grad()
def represent(w: dict, states: torch.Tensor) -> torch.Tensor:
    """``h`` of int8 states ``(B, 6, N, N)`` (canonicalised here)."""
    with no_tf32():
        return scale(_tower(w, "h", canonical(states)))


def action_plane(actions: torch.Tensor, n: int) -> torch.Tensor:
    """``(B, 1, N, N)`` float32: 1 at the stone each action plays, none for a pass."""
    cells = torch.arange(n * n, device=actions.device)
    return (cells == actions.to(torch.int64)[:, None]).to(torch.float32).view(-1, 1, n, n)


@torch.no_grad()
def dynamics(w: dict, s: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """``g(s, a)`` for hidden states ``(B, C, N, N)`` and actions ``(B,)``."""
    with no_tf32():
        return scale(_tower(w, "g", torch.cat([s, action_plane(actions, s.shape[-1])], dim=1)))


@torch.no_grad()
def predict(w: dict, s: torch.Tensor):
    """``f(s)``: ``(policy logits (B, N*N + 1), value (B,))``."""
    with no_tf32():
        p = F.relu(F.conv2d(s, w["policy_conv.weight"], w["policy_conv.bias"])).flatten(1)
        logits = F.linear(p, w["policy_out.weight"], w["policy_out.bias"])
        v = F.relu(F.conv2d(s, w["value_conv.weight"], w["value_conv.bias"])).flatten(1)
        v = F.relu(F.linear(v, w["value_hidden.weight"], w["value_hidden.bias"]))
        value = torch.tanh(F.linear(v, w["value_out.weight"], w["value_out.bias"]))[:, 0]
    return logits, value


def halving_schedule(simulations: int, considered: int) -> list:
    """How many root candidates are in play at each simulation: sequential
    halving from ``considered`` (at least 2), each phase giving each of its
    candidates ``max(1, n // (ceil(log2 m) * in play))`` visits, the last
    candidate the rest of the budget."""
    m = max(2, considered)
    phases = max(1, math.ceil(math.log2(m)))
    out, in_play = [], m
    while len(out) < simulations:
        block = max(1, simulations // (phases * in_play)) * in_play if in_play > 1 else simulations - len(out)
        out += [in_play] * min(block, simulations - len(out))
        in_play = max(1, in_play // 2)
    return out


def _sigma(q: float, max_visits: int, c_visit: float, c_scale: float) -> float:
    return (c_visit + max_visits) * c_scale * q


def _softmax(xs: list) -> list:
    top = max(xs)
    e = [math.exp(x - top) if x != -math.inf else 0.0 for x in xs]
    total = sum(e)
    return [x / total for x in e]


def search(w: dict, state: torch.Tensor, legal: torch.Tensor, gumbel: torch.Tensor, simulations: int,
           considered: int, c_visit: float = 50.0, c_scale: float = 1.0) -> dict:
    """One root's Gumbel MuZero search.

    ``state`` int8 ``(6, N, N)``, ``legal`` bool ``(N*N + 1,)`` (the only
    mask: the root's), ``gumbel`` the root's noise ``(N*N + 1,)``.  Returns
    ``action``, ``visits`` (the root's, a list), ``policy`` (the improved
    policy), ``root_value`` and ``nodes``: for each tree node in the order it
    was made (node 0 the root), ``parent``, ``action``, ``value`` (f's, from
    its mover's view) and ``logits`` (f's, unmasked)."""
    a_size = int(legal.shape[0])
    legal = [bool(x) for x in legal.tolist()]
    g = [float(x) for x in gumbel.tolist()]
    s0 = represent(w, state[None])
    logits0, value0 = predict(w, s0)
    nodes = [{"parent": -1, "action": -1, "s": s0, "logits": logits0[0].double().tolist(),
              "value": float(value0[0]), "visits": {}, "wsum": {}, "child": {}}]
    root_logits = [x if ok else -math.inf for x, ok in zip(nodes[0]["logits"], legal)]
    m = min(considered, a_size)
    noisy = [root_logits[a] + g[a] if legal[a] else -math.inf for a in range(a_size)]
    cand = sorted(range(a_size), key=lambda a: -noisy[a])[:m]  # stable: the lower index first among equals
    schedule = halving_schedule(simulations, m)
    root = nodes[0]

    def q_of(node, a, default):
        n = node["visits"].get(a, 0)
        return node["wsum"][a] / n if n else default

    def root_scores():
        max_n = max(root["visits"].values(), default=0)
        return [noisy[a] + _sigma(q_of(root, a, 0.0), max_n, c_visit, c_scale) if legal[a] else -math.inf
                for a in cand], max_n

    def interior_action(node):
        max_n = max(node["visits"].values(), default=0)
        total = sum(node["visits"].values())
        improved = _softmax([node["logits"][a] + _sigma(q_of(node, a, node["value"]), max_n, c_visit, c_scale)
                             for a in range(a_size)])
        scores = [improved[a] - node["visits"].get(a, 0) / (1 + total) for a in range(a_size)]
        return max(range(a_size), key=lambda a: (scores[a], -a))

    for sim in range(simulations):
        scores, _ = root_scores()
        order = sorted(range(m), key=lambda i: -scores[i])
        rank = {i: r for r, i in enumerate(order)}
        in_play = [i for i in range(m) if rank[i] < schedule[sim] and legal[cand[i]]]
        pick = min(in_play, key=lambda i: (root["visits"].get(cand[i], 0), rank[i]))
        path, node_id, a = [], 0, cand[pick]
        while True:
            path.append((node_id, a))
            nxt = nodes[node_id]["child"].get(a)
            if nxt is None:
                break
            node_id = nxt
            a = interior_action(nodes[node_id])
        parent, a = path[-1]
        s = dynamics(w, nodes[parent]["s"], torch.tensor([a], device=s0.device))
        logits, value = predict(w, s)
        nodes[parent]["child"][a] = len(nodes)
        nodes.append({"parent": parent, "action": a, "s": s, "logits": logits[0].double().tolist(),
                      "value": float(value[0]), "visits": {}, "wsum": {}, "child": {}})
        leaf = nodes[-1]["value"]
        for depth, (nid, act) in enumerate(path):
            sign = -1.0 if (len(path) - 1 - depth) % 2 == 0 else 1.0
            nodes[nid]["visits"][act] = nodes[nid]["visits"].get(act, 0) + 1
            nodes[nid]["wsum"][act] = nodes[nid]["wsum"].get(act, 0.0) + sign * leaf

    scores, max_n = root_scores()
    visited = [scores[i] if root["visits"].get(cand[i], 0) > 0 else -math.inf for i in range(m)]
    action = cand[max(range(m), key=lambda i: (visited[i], -i))]
    policy = _softmax([root_logits[a] + _sigma(q_of(root, a, root["value"]), max_n, c_visit, c_scale)
                       if legal[a] else -math.inf for a in range(a_size)])
    total = sum(root["visits"].values())
    root_value = sum(root["wsum"].values()) / total if total else root["value"]
    return {"action": action, "visits": [root["visits"].get(a, 0) for a in range(a_size)], "policy": policy,
            "root_value": root_value, "candidates": cand,
            "nodes": [{k: nd[k] for k in ("parent", "action", "value", "logits")} for nd in nodes]}
