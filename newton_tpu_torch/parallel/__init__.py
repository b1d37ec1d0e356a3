from .envs import batch_state, unbatch_env, vmap_step

__all__ = ["batch_state", "unbatch_env", "vmap_step"]
