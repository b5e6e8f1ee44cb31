"""deepflow-tpu on PyTorch: the probe and its flagship workload for CUDA.

A port of the JAX package ``deepflow_tpu`` to PyTorch on NVIDIA GPUs. It
keeps the JAX package's module layout and wire formats, so frames it emits
decode and ingest unchanged on the reference server. It imports torch,
numpy and the standard library only: nothing of ``jax`` and nothing of
``deepflow_tpu``. Importing the package loads no torch: the server and
``dfctl`` touch no device, and ``resolve_device`` imports torch when it
is first asked for.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    if name == "resolve_device":
        from deepflow_tpu_torch.device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
