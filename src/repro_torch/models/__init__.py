"""repro_torch.models — the dense transformer of the port."""
