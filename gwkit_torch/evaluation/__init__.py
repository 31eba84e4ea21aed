"""MLGWSC-1 challenge statistics (counterpart of ``gwkit/evaluation``):
FAR curves and the sensitive volume and distance, numpy on the host, equal
to gwkit's outputs exactly."""
