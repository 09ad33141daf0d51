"""Training step."""
from .loop import masked_cross_entropy
