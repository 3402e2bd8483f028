from repro_torch.models.transformer import init_params, loss_fn
