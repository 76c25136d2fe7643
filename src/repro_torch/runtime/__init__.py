"""repro_torch.runtime — the fault-tolerant step loop (``runtime.fault``)."""
