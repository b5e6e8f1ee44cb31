"""Which communicator issued each NCCL call: the call log that the port's
collectives write and the probe reads.

A rank of a model-parallel job talks over several communicators (one per
mesh axis: data, fsdp, tensor, ...). Their calls run NCCL kernels of the
same few names, and a CUDA-only Kineto capture names no process group on
a kernel (PERF.md), so the kernel alone cannot say which communicator
ran it. The port's collectives (``parallel/collectives.py``)
record each call's host window here, ``time.time_ns()`` before and after
the call with the communicator's id, on the clock the capture's launch
events and the step hook's marks share. NCCL launches a call's kernel on
the host thread inside the call, so the Kineto parser takes each NCCL
kernel's communicator from the window that holds its launch
(``kineto.py``).

A communicator's id is its mesh axis's place in ``COMM_AXES`` plus one:
the same on every rank of a mesh dimension whatever order the groups
were made in, so the n-th call of the tensor communicator in a step is
one call on every rank. An NCCL span's ``program_id`` is then
``comm * CALL_STRIDE + ordinal`` (the ordinal counted per communicator
in the step); a kernel that no logged call launched (a user's own
``torch.distributed`` call) keeps comm 0, and ``program_id`` is the
ordinal on its stream.

``CALLS`` is the process's one log: the workload writes it and the probe
reads it without a reference to each other, as the optimizer step hook
joins them. It keeps the last ``MAX_CALLS`` windows.
"""

from __future__ import annotations

import collections
import threading
import time

COMM_AXES = ("data", "fsdp", "tensor", "sp", "pp", "ep")
CALL_STRIDE = 1_000_000   # program_id = comm * CALL_STRIDE + ordinal
MAX_CALLS = 1 << 16       # a window of 20 steps at ~3,000 calls a step


def comm_id(axis: str) -> int:
    """The communicator id of a mesh axis (1 + its place in COMM_AXES)."""
    try:
        return COMM_AXES.index(axis) + 1
    except ValueError:
        raise ValueError(f"unknown mesh axis {axis!r}: the call log names "
                         f"{COMM_AXES}") from None


def comm_axis(comm: int) -> str:
    """The mesh axis of a communicator id; "" for 0 (not logged)."""
    return COMM_AXES[comm - 1] if 0 < comm <= len(COMM_AXES) else ""


class CallLog:
    """Host windows of collective calls, and each communicator's size."""

    def __init__(self, max_calls: int = MAX_CALLS) -> None:
        self._lock = threading.Lock()
        self._calls: collections.deque = collections.deque(maxlen=max_calls)
        self._sizes: dict[int, int] = {}
        self._counts: dict[int, int] = {}

    def record(self, comm: int, size: int, t0_ns: int, t1_ns: int) -> None:
        with self._lock:
            self._calls.append((t0_ns, t1_ns, comm))
            self._sizes[comm] = size
            self._counts[comm] = self._counts.get(comm, 0) + 1

    def since(self, t_ns: int) -> list[tuple[int, int, int]]:
        """[(t0 ns, t1 ns, comm)] of the calls that began at t_ns or
        later, in call order."""
        with self._lock:
            return [c for c in self._calls if c[0] >= t_ns]

    def sizes(self) -> dict[int, int]:
        """comm -> the size of its group, as its calls recorded it."""
        with self._lock:
            return dict(self._sizes)

    def counts(self) -> dict[str, int]:
        """Calls so far, by mesh axis."""
        with self._lock:
            return {comm_axis(c): n for c, n in sorted(self._counts.items())}

    def clear(self) -> None:
        with self._lock:
            self._calls.clear()
            self._sizes.clear()
            self._counts.clear()


CALLS = CallLog()


class logged:
    """``with logged(axis, size): dist.<call>(...)`` records the call's
    host window under the axis's communicator."""

    __slots__ = ("comm", "size", "t0")

    def __init__(self, axis: str, size: int) -> None:
        self.comm = comm_id(axis)
        self.size = size

    def __enter__(self) -> "logged":
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        CALLS.record(self.comm, self.size, self.t0, time.time_ns())
