"""Operations for the training loops (counterpart of ``repro/distributed``):
crash-safe checkpoints (:mod:`repro_torch.distributed.checkpoint`)."""
