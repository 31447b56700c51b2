"""repro_torch.precision — weight quantization for serving (``qat``)."""
