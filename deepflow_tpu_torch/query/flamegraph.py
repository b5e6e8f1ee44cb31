"""Flame-graph tree assembly from folded stacks, and the per-kernel
device-time flame over span events.

``build_flame_tree`` is an own copy of the reference's
(``deepflow_tpu/query/flamegraph.py``); ``device_flame`` folds spans as
the reference server's ``tpu_flame`` query does
(``deepflow_tpu/server/querier.py``), without the store in between.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from deepflow_tpu_torch.proto import wire

SEP = ";"
DEVICE_KINDS = (wire.DEVICE_COMPUTE, wire.DEVICE_COLLECTIVE,
                wire.DEVICE_TRANSFER)


@dataclass
class FlameNode:
    name: str
    total_value: int = 0
    self_value: int = 0
    children: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "total_value": int(self.total_value),
            "self_value": int(self.self_value),
            "children": [c.to_dict() for c in
                         sorted(self.children.values(),
                                key=lambda n: -n.total_value)],
        }


def build_flame_tree(stacks: list[str], values: list[int],
                     root_name: str = "root") -> FlameNode:
    """Merge folded stacks ("a;b;c") weighted by values into a tree."""
    root = FlameNode(root_name)
    for stack, value in zip(stacks, values):
        if not stack:
            continue
        root.total_value += value
        node = root
        for frame in stack.split(SEP):
            child = node.children.get(frame)
            if child is None:
                child = FlameNode(frame)
                node.children[frame] = child
            child.total_value += value
            node = child
        node.self_value += value
    return root


def device_flame(spans, include_host: bool = False) -> FlameNode:
    """Device time folded as module;category;op over span events
    (TpuSpanEvent or decoded wire.TpuSpan). Device kinds only unless
    include_host; spans of zero duration are left out, as tpu_flame's
    ``duration_ns > 0``."""
    sums: dict[tuple[str, str, str], int] = {}
    for s in spans:
        if s.duration_ns <= 0:
            continue
        if not include_host and s.kind not in DEVICE_KINDS:
            continue
        key = (s.hlo_module, s.hlo_category, s.hlo_op)
        sums[key] = sums.get(key, 0) + int(s.duration_ns)
    stacks, values = [], []
    for (mod, cat, op), d in sums.items():
        stacks.append(SEP.join(x for x in (mod, cat or "other", op) if x))
        values.append(d)
    return build_flame_tree(stacks, values)
