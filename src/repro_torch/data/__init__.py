"""repro_torch.data — the deterministic synthetic LM token stream."""
from .pipeline import Cursor, TokenStream, TokenStreamConfig

__all__ = ["Cursor", "TokenStream", "TokenStreamConfig"]
