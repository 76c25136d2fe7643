"""repro_torch.data — the deterministic synthetic batches of training."""
