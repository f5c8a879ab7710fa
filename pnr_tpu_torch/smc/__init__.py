"""Sequential Monte Carlo tracer."""
