"""Node-graph refinement."""
