from repro_torch.models.transformer import init_params, loss_and_aux, loss_fn
