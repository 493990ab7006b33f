"""Optimizers (counterpart of ``repro/optim``): AdamW with the cosine
schedule and global-norm clipping (:mod:`repro_torch.optim.adamw`)."""
