"""Deterministic synthetic data pipelines (counterpart of ``repro/data``):
:mod:`repro_torch.data.pipeline`."""
