"""Agent side of the probe: its configuration and frame sink."""
