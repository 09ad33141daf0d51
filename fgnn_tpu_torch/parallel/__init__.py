"""Batch order (multi-device engines are not ported yet)."""
