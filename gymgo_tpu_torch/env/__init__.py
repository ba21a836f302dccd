from gymgo_tpu_torch.env.batch_env import BatchGoEnv, Rollout, StepResult, rollout
from gymgo_tpu_torch.env.go_env import GoEnv, RewardMethod
from gymgo_tpu_torch.env.go_extrahard_env import GoExtraHardEnv
