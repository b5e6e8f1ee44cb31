"""The port's profile server: TCP ingest of TPU_SPAN / STEP_METRICS
frames into the in-memory store, and the profile queries over HTTP."""

from deepflow_tpu_torch.server.server import Server

__all__ = ["Server"]
