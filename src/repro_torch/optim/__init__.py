from repro_torch.optim.optimizer import (
    apply_updates, check_optimizer, init_opt_state, lr_at_step,
    opt_shard_len,
)
