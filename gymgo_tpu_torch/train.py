"""AZ-style actor-learner training loop (counterpart of the JAX package's
``train.py``, with the same flags and defaults).

Each iteration: a window of batched self-play (Gumbel MCTS, PUCT MCTS, the
one-ply lookahead, or the raw policy) -> optional dihedral augmentation ->
the on-device replay -> one AdamW step on a uniform replay sample -> the
print line; then evaluation and checkpoints on their cadences.  The learner
holds float32 parameters; self-play, evaluation and the frozen target network
run bfloat16 copies refreshed after each update (the values flax computes with
when it casts float32 parameters at the call).

    python -m gymgo_tpu_torch.train --board 5 --envs 16 --channels 16 \\
        --blocks 1 --rollout-steps 16 --iters 3 --cpu

Runs on the card unless ``--cpu`` is given, and raises when there is none.
``--resume`` takes this trainer's checkpoint or one of the JAX package's
``train.py`` (its threefry key cannot be carried: the generator is seeded from
``--seed``).  ``Trainer`` is the loop as an object, for callers in the same
process.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from gymgo_tpu_torch import convert
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core.actions import uniform_random_actions
from gymgo_tpu_torch.core.state import batch_init_state, resolve_device
from gymgo_tpu_torch.models.az_net import AZNetConfig, acting_copy, init_params, refresh_
from gymgo_tpu_torch.models.surgery import reinit_value_head, zero_moments_for
from gymgo_tpu_torch.rl.evaluate import play_match, with_pass_to_win
from gymgo_tpu_torch.rl.gumbel_mcts import make_gumbel_mcts_policy
from gymgo_tpu_torch.rl.learner import TrainState, make_jitted_train_step, make_train_state
from gymgo_tpu_torch.rl.replay import ReplayBuffer, ReplayState
from gymgo_tpu_torch.rl.search import make_search_policy
from gymgo_tpu_torch.rl.selfplay import (
    augment_symmetries,
    selfplay_gumbel_rollout,
    selfplay_mcts_rollout,
    selfplay_rollout,
    selfplay_search_rollout,
)
from gymgo_tpu_torch.utils import checkpoint as ckpt
from gymgo_tpu_torch.utils.profiling import Meter

__all__ = ["build_parser", "trainer_tree", "load_trainer_tree", "restore_learner", "Trainer", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m gymgo_tpu_torch.train", description=__doc__.split("\n\n")[0])
    ap.add_argument("--board", type=int, default=9)
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--rollout-steps", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--train-batch", type=int, default=1024)
    ap.add_argument("--replay-capacity", type=int, default=1 << 16)
    ap.add_argument("--komi", type=float, default=0.0)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--mcts-sims", type=int, default=0,
                    help=">0: PUCT MCTS self-play with this simulation budget per move; "
                         "targets = visit-count policies")
    ap.add_argument("--mcts-par", type=int, default=1,
                    help="leaf-parallel MCTS wave size (batched virtual loss); must divide --mcts-sims")
    ap.add_argument("--mcts-reuse", nargs="?", const="root", default="", choices=["root", "subtree"],
                    help="reuse the played root child's statistics (root) or whole subtree across plies")
    ap.add_argument("--gumbel-sims", type=int, default=0,
                    help=">0: Gumbel MCTS (sequential halving) self-play with this simulation budget; "
                         "targets = completed-Q improved policies")
    ap.add_argument("--gumbel-m", type=int, default=16, help="max root actions considered by sequential halving")
    ap.add_argument("--search-k", type=int, default=8,
                    help=">0: one-ply Gumbel lookahead self-play with this many sampled actions. 0 disables "
                         "search: the policy trains on its own softmax and collapses toward always-pass "
                         "(the cheap data-generation baseline)")
    ap.add_argument("--pass-min-stones", type=int, default=-1,
                    help="forbid pass in self-play while the board holds fewer stones than this and another "
                         "legal move exists. -1 = auto (board_size^2 // 2); 0 disables")
    ap.add_argument("--value-bootstrap", action="store_true",
                    help="truncated-window value targets bootstrap from a FROZEN target network's value head "
                         "at the window-final states, refreshed every --target-update iterations")
    ap.add_argument("--target-update", type=int, default=8,
                    help="iterations between hard online->target copies for --value-bootstrap")
    ap.add_argument("--value-grounded-only", action="store_true",
                    help="truncated-tail rows train the POLICY only: their value targets are left out of the loss")
    ap.add_argument("--reinit-value-head", action="store_true",
                    help="with --resume: draw the value head afresh (final layer zero) and zero its AdamW "
                         "moments, keeping the trunk and the policy head")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help=">0: with --checkpoint PATH.npz, also save snapshots PATH_iterK.npz every K iterations")
    ap.add_argument("--augment", action="store_true", help="random dihedral symmetry augmentation of replay data")
    ap.add_argument("--eval-every", type=int, default=0,
                    help=">0: every K iters, match the current net (one-ply search) against uniform random")
    ap.add_argument("--eval-games", type=int, default=64)
    ap.add_argument("--eval-sims", type=int, default=0,
                    help=">0: evaluate with full Gumbel MCTS at this many simulations instead of the one-ply "
                         "k=8 lookahead")
    ap.add_argument("--eval-raw-pass", action="store_true",
                    help="evaluate WITHOUT the pass-to-win match rule (rl.evaluate.with_pass_to_win)")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help=">0: also save the checkpoint every K iterations (resume with --resume)")
    ap.add_argument("--resume", default="",
                    help="checkpoint to resume from: this trainer's (bit-exact continuation) or a JAX "
                         "train.py checkpoint")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _state_dict_f32(net) -> dict:
    return {k: v.detach().to(torch.float32) for k, v in net.state_dict().items()}


def trainer_tree(train_state: TrainState, buf_state: ReplayState, env_states, generator, iteration: int,
                 target) -> dict:
    """The trainer's checkpoint tree (``utils.checkpoint.save_npz`` writes
    it): float32 ``params`` and ``target_params`` (state_dict names), the
    AdamW state (``opt_state``: one ``step`` count and per-parameter
    ``exp_avg`` / ``exp_avg_sq``, zeros before the first update), the update
    ``step``, the replay ``buf``, ``env_states``, the ``generator``'s state and
    its device type, and the ``iteration`` counter."""
    net, optimizer = train_state.net, train_state.optimizer
    exp_avg, exp_avg_sq, steps = {}, {}, set()
    for name, p in net.named_parameters():
        st = optimizer.state.get(p) or {}
        exp_avg[name] = st.get("exp_avg", torch.zeros_like(p)).detach()
        exp_avg_sq[name] = st.get("exp_avg_sq", torch.zeros_like(p)).detach()
        steps.add(float(st.get("step", 0.0)))
    if len(steps) != 1:
        raise ValueError(f"the parameters' AdamW steps differ: {sorted(steps)}")
    return {
        "params": _state_dict_f32(net),
        "opt_state": {"step": np.float32(steps.pop()), "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq},
        "step": np.int64(train_state.step),
        "buf": buf_state._asdict(),
        "env_states": env_states,
        "generator": generator.get_state(),
        "generator_device": np.str_(generator.device.type),
        "iteration": np.int64(iteration),
        "target_params": _state_dict_f32(target),
    }


def load_trainer_tree(path) -> dict:
    """A checkpoint as a trainer tree: this trainer's, or the JAX package's
    ``train.py`` one (through ``convert.trainer_tree_from_jax_npz``)."""
    with np.load(path) as data:
        from_jax = "__def__params" in data.files
    return convert.trainer_tree_from_jax_npz(path) if from_jax else ckpt.restore_npz(path)


def restore_learner(train_state: TrainState, tree: dict) -> TrainState:
    """``train_state`` with the parameters, the AdamW state and the update
    step of a trainer tree, loaded in place (bit-exact)."""
    as_t = torch.as_tensor
    net, opt = train_state.net, train_state.optimizer
    net.load_state_dict({k: as_t(v) for k, v in tree["params"].items()}, strict=True)
    sd = opt.state_dict()
    step = torch.tensor(float(tree["opt_state"]["step"]), dtype=torch.float32)
    moments = tree["opt_state"]
    sd["state"] = {
        i: {"step": step.clone(), "exp_avg": as_t(moments["exp_avg"][name]),
            "exp_avg_sq": as_t(moments["exp_avg_sq"][name])}
        for i, (name, _) in enumerate(net.named_parameters())
    }
    opt.load_state_dict(sd)
    return train_state._replace(step=int(tree["step"]))


class Trainer:
    """The training loop of ``main`` as an object: ``run`` does every
    iteration, ``run_iteration`` one (self-play, store, learn, print, then
    evaluation and checkpoints on their cadences)."""

    def __init__(self, args: argparse.Namespace, device=None, log=print):
        a = self.args = args
        self.log = log
        self.device = resolve_device("cpu" if a.cpu else device)
        self.env_cfg = EnvConfig(board_size=a.board, batch_size=a.envs, komi=a.komi, auto_reset=True)
        self.net_cfg = AZNetConfig(board_size=a.board, channels=a.channels, blocks=a.blocks)
        self.generator = torch.Generator(device=self.device).manual_seed(a.seed)
        self.train_state = make_train_state(init_params(self.generator, self.net_cfg), learning_rate=a.lr)
        self.buf = ReplayBuffer(a.replay_capacity, a.board, self.device)
        self.buf_state = self.buf.init()
        self.states = batch_init_state(a.envs, a.board, device=self.device)
        self.iteration = 0
        self.pass_min = a.board * a.board // 2 if a.pass_min_stones < 0 else a.pass_min_stones
        # the bfloat16 copies: self-play and evaluation, and the frozen target
        # network of --value-bootstrap (kept without it too, so every
        # checkpoint has one shape)
        self.acting = acting_copy(self.net)
        self.target = acting_copy(self.net)
        self.meter = Meter()
        self._learn = None  # the compiled learner step (``learn``)
        self._eval_policy = None  # the match policy of ``evaluate``, made at its first call
        if (a.checkpoint_every or a.snapshot_every) and not a.checkpoint:
            log("warning: --checkpoint-every/--snapshot-every have no effect without --checkpoint", flush=True)
        if a.resume:
            self.restore(load_trainer_tree(a.resume))
            log(f"resumed from {a.resume} at iteration {self.iteration}", flush=True)
        if a.reinit_value_head:
            if not a.resume:
                log("warning: --reinit-value-head without --resume is a no-op (params are already fresh)",
                    flush=True)
            else:
                reinit_value_head(self.net, self.generator)
                zero_moments_for(self.train_state.optimizer, self.net)
                refresh_(self.acting, self.net)
                refresh_(self.target, self.net)
                log("value head re-initialized (fresh value_conv/value_hidden/value_out, AdamW moments zeroed)",
                    flush=True)

    @property
    def net(self):
        return self.train_state.net

    def tree(self) -> dict:
        return trainer_tree(self.train_state, self.buf_state, self.states, self.generator, self.iteration,
                            self.target)

    def restore(self, tree: dict) -> None:
        """Continue from a trainer tree (numpy arrays or tensors)."""
        dev = self.device
        as_t = torch.as_tensor
        self.train_state = restore_learner(self.train_state, tree)
        buf = {k: as_t(v).to(dev) for k, v in tree["buf"].items()}
        buf["cursor"], buf["filled"] = buf["cursor"].to(torch.int64), buf["filled"].to(torch.int64)
        expected = self.buf_state._asdict()
        for k, v in buf.items():
            if v.shape != expected[k].shape:
                raise ValueError(f"replay {k}: the checkpoint's {tuple(v.shape)} does not fit "
                                 f"--replay-capacity {self.args.replay_capacity} at board {self.args.board}")
        self.buf_state = ReplayState(**{k: buf[k].to(expected[k].dtype) for k in ReplayState._fields})
        states = as_t(tree["env_states"]).to(dev, torch.int8)
        if states.shape == self.states.shape:
            self.states = states
        else:
            self.log(f"note: --envs {self.args.envs} != checkpoint {states.shape[0]}; env states reset fresh",
                     flush=True)
        if "generator" not in tree:
            self.log(f"note: a JAX key cannot seed a torch generator; seeded from --seed {self.args.seed}",
                     flush=True)
        elif not self._restore_generator(tree):
            self.log(f"note: the checkpoint's generator is not one of a {dev.type} generator; seeded from "
                     f"--seed {self.args.seed}", flush=True)
        self.iteration = int(tree["iteration"])
        self.target.load_state_dict({k: as_t(v) for k, v in tree["target_params"].items()}, strict=True)
        refresh_(self.acting, self.net)

    def _restore_generator(self, tree: dict) -> bool:
        """Set the generator to the checkpoint's state; False (the generator
        left seeded from ``--seed``) when that state is one of another device
        type's generator, or one this generator rejects."""
        saved = tree.get("generator_device")
        if saved is not None and str(saved) != self.device.type:
            return False
        try:
            self.generator.set_state(torch.as_tensor(tree["generator"]).to(torch.uint8))
        except RuntimeError:
            return False
        return True

    def selfplay(self):
        """One window of self-play from the env states (which it advances);
        returns the ``SelfPlayBatch``."""
        a, cfg = self.args, self.env_cfg
        common = dict(pass_min_stones=self.pass_min, value_bootstrap=a.value_bootstrap, target_net=self.target)
        if a.gumbel_sims > 0:
            final, batch = selfplay_gumbel_rollout(
                self.generator, self.states, self.acting, a.rollout_steps, cfg,
                num_simulations=a.gumbel_sims, max_considered=a.gumbel_m, **common)
        elif a.mcts_sims > 0:
            final, batch = selfplay_mcts_rollout(
                self.generator, self.states, self.acting, a.rollout_steps, cfg, num_simulations=a.mcts_sims,
                num_parallel=a.mcts_par, tree_reuse=a.mcts_reuse or False, **common)
        elif a.search_k > 0:
            final, batch = selfplay_search_rollout(
                self.generator, self.states, self.acting, a.rollout_steps, cfg, num_sampled=a.search_k, **common)
        else:
            final, batch = selfplay_rollout(
                self.generator, self.states, self.acting, a.rollout_steps, cfg, temperature=a.temperature,
                **common)
        self.states = final
        return batch

    def store(self, batch) -> torch.Tensor:
        """Flatten the window into replay rows (augmented with ``--augment``)
        and add them; returns the grounded share of the live rows, the
        diagnostic of how much of the value loss is real outcomes."""
        live = batch.mask
        gfrac = (batch.grounded & live).sum(dtype=torch.float32) / live.sum(dtype=torch.float32).clamp_min(1.0)
        obs = batch.obs.flatten(0, 1)
        pi = batch.policy_target.flatten(0, 1)
        mask = live.flatten()
        vmask = (batch.grounded & live).flatten() if self.args.value_grounded_only else mask
        if self.args.augment:
            obs, pi = augment_symmetries(self.generator, obs, pi)
        self.buf_state = self.buf.add(self.buf_state, obs, pi, batch.value_target.flatten(), mask, vmask)
        return gfrac

    def _sample(self, filled, generator):
        """A uniform replay sample of ``--train-batch`` rows; the rows are
        written in place by ``store``, only ``filled`` changes."""
        return self.buf.sample(self.buf_state._replace(filled=filled), generator, self.args.train_batch)

    def learn(self) -> dict:
        """One AdamW step on a uniform replay sample, the sample and the step
        one compiled program on the card (JAX's ``learn_iter``; made at the
        first call, after any restore); refreshes the acting copy."""
        if self._learn is None:
            self._learn = make_jitted_train_step(self.train_state, sample=self._sample)
        self.train_state, metrics = self._learn(self.train_state, self.buf_state.filled, self.generator)
        refresh_(self.acting, self.net)
        return metrics

    def evaluate(self):
        """A match of the acting net against the uniform sampler.  The policy
        is built once, so that every evaluation replays the match's graphs
        (``rl.evaluate.play_match`` keys them by the policy)."""
        if self._eval_policy is None:
            self._eval_policy = self._make_eval_policy()
        a = self.args
        return play_match(self.generator, self._eval_policy, uniform_random_actions, self.env_cfg,
                          num_games=a.eval_games, max_steps=3 * a.board * a.board, device=self.device)

    def _make_eval_policy(self):
        a = self.args
        # with the pass-to-win wrapper, suppress pass INSIDE the search so its
        # own ranking picks the best board move; the wrapper then only adds
        # the game-sealing pass
        no_pass = 0 if a.eval_raw_pass else 1 << 20
        if a.eval_sims > 0:
            policy = make_gumbel_mcts_policy(self.acting, num_simulations=a.eval_sims, max_considered=a.gumbel_m,
                                             komi=a.komi, pass_min_stones=no_pass)
        else:
            policy = make_search_policy(self.acting, num_sampled=8, komi=a.komi, pass_min_stones=no_pass)
        if not a.eval_raw_pass:
            policy = with_pass_to_win(policy, komi=a.komi)
        return policy

    def save(self, it_done: int, main: bool = True) -> None:
        a = self.args
        self.iteration = it_done
        if main:
            ckpt.save_npz(a.checkpoint, self.tree())
        if a.snapshot_every and it_done % a.snapshot_every == 0:
            stem = a.checkpoint[:-4] if a.checkpoint.endswith(".npz") else a.checkpoint
            ckpt.save_npz(f"{stem}_iter{it_done}.npz", self.tree())

    def run_iteration(self, it: int) -> dict:
        a, log = self.args, self.log
        if a.value_bootstrap and it % max(a.target_update, 1) == 0:
            refresh_(self.target, self.net)
        batch = self.selfplay()
        gfrac = self.store(batch)
        metrics = self.learn()
        sps = self.meter.update(a.envs * a.rollout_steps)
        log(f"iter {it}: loss={float(metrics['loss']):.4f} pi={float(metrics['policy_loss']):.4f} "
            f"v={float(metrics['value_loss']):.4f} grounded={float(gfrac):.2f} "
            f"replay={int(self.buf_state.filled)} env-steps/s={sps:,.0f}", flush=True)
        if a.eval_every and (it + 1) % a.eval_every == 0:
            res = self.evaluate()
            extra = f", area-adjudicated={float(res.a_scored_winrate):.2f}" if int(res.unfinished) else ""
            log(f"  eval vs random: winrate={float(res.a_winrate):.2f} ({int(res.policy_a_wins)}W/"
                f"{int(res.policy_b_wins)}L/{int(res.ties)}T, {int(res.unfinished)} unfinished{extra})", flush=True)
        due = lambda every: every and (it + 1) % every == 0
        if a.checkpoint and (due(a.checkpoint_every) or due(a.snapshot_every)):
            # the main checkpoint rewrites only on its own cadence
            self.save(it + 1, main=bool(due(a.checkpoint_every)))
            log(f"  checkpoint saved at iteration {it + 1}", flush=True)
        self.iteration = it + 1
        return metrics

    def run(self) -> None:
        self.meter = Meter()
        for it in range(self.iteration, self.args.iters):
            self.run_iteration(it)
        if self.args.checkpoint:
            self.save(self.args.iters)
            self.log(f"saved checkpoint to {self.args.checkpoint}", flush=True)


def main(argv=None) -> int:
    Trainer(build_parser().parse_args(argv)).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
