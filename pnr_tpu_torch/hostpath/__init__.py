"""Host-side helpers shared with the tracer: the Threefry port."""
