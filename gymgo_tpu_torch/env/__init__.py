from gymgo_tpu_torch.env.batch_env import BatchGoEnv, Rollout, StepResult, rollout
