"""Framework-free layer primitives (counterpart of ``repro/layers``)."""
