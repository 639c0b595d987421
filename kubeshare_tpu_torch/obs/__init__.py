"""Observability of the port: :mod:`.metrics`, the labeled counters,
gauges and histograms the preemption and serving planes record into."""
