"""repro_torch.launch — the port's launchers (``serve``)."""
