"""Online GNN inference serving (the AdaptGear read path).

Counterpart of ``repro/serve``: answering ego-net queries over a trained
model on the card, with deadline-aware micro-batching, admission control
with explicit load shedding, a hysteretic graceful-degradation ladder
over pre-recorded fanout rungs, and persisted-plan warm starts (no shape
record in steady state).  Kernel-fault quarantine is not ported (ROADMAP
section 1 item 7): a kernel that fails fails its batch's requests.  See
serve/server.py for the dataflow.
"""
from repro_torch.serve.admission import (ERROR, OK, PENDING, SHED, TIMEOUT,
                                         AdmissionController, Request,
                                         ServeFuture)
from repro_torch.serve.degrade import DegradationLadder
from repro_torch.serve.ego import EgoNetSampler, default_rungs
from repro_torch.serve.server import InferenceServer, ServeConfig

__all__ = [
    "AdmissionController", "DegradationLadder", "EgoNetSampler",
    "InferenceServer", "Request", "ServeConfig", "ServeFuture",
    "default_rungs",
    "PENDING", "OK", "SHED", "TIMEOUT", "ERROR",
]
