"""The port's profile server: TCP ingest of PROFILE, TPU_SPAN,
STEP_METRICS and DFSTATS frames with acks and dedup into the in-memory
store, and the profile queries over HTTP."""

from deepflow_tpu_torch.server.server import Server

__all__ = ["Server"]
