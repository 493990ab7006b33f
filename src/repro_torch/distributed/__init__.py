"""Operations for the training loops (counterpart of ``repro/distributed``):
crash-safe checkpoints (:mod:`repro_torch.distributed.checkpoint`),
retries, liveness tools and deterministic fault injection
(:mod:`repro_torch.distributed.fault_tolerance`) and the elastic re-mesh
plan (:mod:`repro_torch.distributed.elastic`)."""
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    FaultPlan, HeartbeatMonitor, InjectedWorkerFault, KernelFault,
    RetryPolicy, SimulatedCrash, StragglerDetector, TransientError,
    default_transient, fault_kernel_from, reassign_shards)
