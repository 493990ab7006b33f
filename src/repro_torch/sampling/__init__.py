"""Mini-batch sampled-subgraph training: the samplers and the PlanCache.

Counterpart of ``repro/sampling/__init__.py``.  Sampling makes every
training step a fresh density distribution, the regime where the paper's
§4 selection has to be amortized rather than recomputed:

  graphs.Graph
      |  sampling.sampler (ClusterSampler | NeighborSampler)
      v
  SampledBatch -- fixed-shape padded node/edge budgets (masked loss)
      |  core.decompose.decompose_skeleton(reorder=False,
      |  keep_empty_buckets=True, edge_budget=...)  [one partition pass]
      v
  DecomposeSkeleton (per batch)
      |  sampling.plan_cache.PlanCache -- quantized density signature read
      |  off the skeleton -> memoized KernelPlan (cost-model selection on
      |  miss, probe-on-Nth-miss pinning, reuse on hit); then
      |  skel.materialize(plan_payload_keys(plan)) builds only the
      |  committed payloads, fix_shapes pads them to the edge budget
      v
  train.gnn_steps.make_sampled_step -- one step per committed plan, on
      the device that trains
"""
from repro_torch.sampling.plan_cache import (MB_KERNELS, PlanCache,
                                             density_signature, fix_shapes,
                                             plan_payload_keys)
from repro_torch.sampling.sampler import (ClusterSampler, DrawTicket,
                                          NeighborSampler, SampledBatch)

__all__ = ["ClusterSampler", "DrawTicket", "NeighborSampler",
           "SampledBatch", "PlanCache", "MB_KERNELS", "density_signature",
           "fix_shapes", "plan_payload_keys"]
