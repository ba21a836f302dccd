"""Search and match play on the batched Go env (counterpart of ``gymgo_tpu.rl``)."""

from gymgo_tpu_torch.rl.evaluate import MatchResult, play_match, with_pass_to_win
from gymgo_tpu_torch.rl.gumbel_mcts import (
    GumbelMCTSResult,
    make_gumbel_mcts_policy,
    run_gumbel_mcts,
    seq_halving_schedule,
)
from gymgo_tpu_torch.rl.search import SearchResult, gumbel_oneply, make_search_policy
