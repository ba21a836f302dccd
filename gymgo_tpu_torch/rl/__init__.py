"""Search, match play, self-play, replay and the learner on the batched Go env
(counterpart of ``gymgo_tpu.rl``)."""

from gymgo_tpu_torch.rl.evaluate import MatchResult, play_match, with_pass_to_win
from gymgo_tpu_torch.rl.gumbel_mcts import (
    GumbelMCTSResult,
    LearnedMCTSResult,
    make_gumbel_mcts_policy,
    run_gumbel_mcts,
    seq_halving_schedule,
)
from gymgo_tpu_torch.rl.search import SearchResult, gumbel_oneply, make_search_policy
from gymgo_tpu_torch.rl.learner import TrainState, az_loss, make_train_state, train_step
from gymgo_tpu_torch.rl.mcts import MCTSResult, make_mcts_policy, run_mcts
from gymgo_tpu_torch.rl.replay import ReplayBuffer, ReplayState
from gymgo_tpu_torch.rl.selfplay import (
    SelfPlayBatch,
    selfplay_gumbel_rollout,
    selfplay_mcts_rollout,
    selfplay_rollout,
    selfplay_search_rollout,
)
