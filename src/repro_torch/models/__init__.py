"""LM-family models (counterpart of ``repro/models``)."""
