"""The port's profile server: TCP ingest of PROFILE, TPU_SPAN,
STEP_METRICS and DFSTATS frames with acks and dedup into the in-memory
store, the profile queries over HTTP, and the agents' controller."""

from deepflow_tpu_torch.server.server import Server

__all__ = ["Server"]
