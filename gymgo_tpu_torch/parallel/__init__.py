from gymgo_tpu_torch.parallel.mesh import (
    env_sharding,
    fold_env_keys,
    make_mesh,
    replicated,
    shard_states,
)
from gymgo_tpu_torch.parallel.sharded_env import ShardedGoEnv
