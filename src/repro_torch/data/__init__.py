from repro_torch.data.synthetic import lm_batch
