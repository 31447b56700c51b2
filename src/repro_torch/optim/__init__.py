"""repro_torch.optim — AdamW with f32 masters and int8-quantized moments."""
