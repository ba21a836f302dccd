"""Env-steps completed in the window (games x steps) per second of it."""


def read(run):
    if "env_steps" not in run.host:
        return None
    return run.host["env_steps"] / run.host["window_s"]
