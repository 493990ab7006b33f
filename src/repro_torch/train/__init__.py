"""Step factories of the LM stack (counterpart of ``repro/train``)."""
