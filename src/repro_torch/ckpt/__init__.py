"""repro_torch.ckpt — the ``weights-bitplane-v1`` ship artifact (one
bit-plane file that serves every precision). Checkpoints of the full
training state wait for ROADMAP A8."""
from .ship import FORMAT, ShipArtifactError, load_ship_weights, save_ship_weights

__all__ = ["FORMAT", "ShipArtifactError", "load_ship_weights", "save_ship_weights"]
