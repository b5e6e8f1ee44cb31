"""Flame-graph tree assembly from folded stacks, the CPU flame graph over
the profile table, and the per-kernel device-time flame over span events.

``build_flame_tree``, ``trace_flame_stacks``, ``profile_stack_values``,
``merge_stack_values`` and ``profile_flame_tree`` are own copies of the
reference's
(``deepflow_tpu/query/flamegraph.py``); ``device_flame`` folds spans as
the reference server's ``tpu_flame`` query does
(``deepflow_tpu/server/querier.py``), without the store in between.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.store.table import ColumnarTable

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


def trace_flame_stacks(tree: dict) -> tuple[list[str], list[int]]:
    """An assembled trace tree (``build_trace_from_spans``) as folded
    stacks weighted by self time in ns: each span's duration less its
    children's, so the flame graph shows where a query or request spent
    its wall clock. Feed the result to ``build_flame_tree``."""
    stacks: list[str] = []
    values: list[int] = []

    def walk(node: dict, prefix: str) -> None:
        label = f"{node['service']}:{node['name']}" \
            if node.get("service") else node["name"]
        path = f"{prefix}{SEP}{label}" if prefix else label
        child_ns = sum(int(c.get("duration_ns", 0))
                       for c in node.get("children", []))
        self_ns = max(0, int(node.get("duration_ns", 0)) - child_ns)
        if self_ns:
            stacks.append(path)
            values.append(self_ns)
        for c in node.get("children", []):
            walk(c, path)

    for root in tree.get("spans", []):
        walk(root, "")
    return stacks, values


def profile_stack_values(table: ColumnarTable,
                         time_start_ns: int | None = None,
                         time_end_ns: int | None = None,
                         event_type: str | None = None,
                         app_service: str | None = None,
                         profiler: str | None = None) -> tuple[list, list]:
    """(folded stacks, summed values) of the rows that pass the filters:
    grouped by the stack's dictionary id, and only the surviving ids are
    decoded. A None filter is no filter; an unknown app_service or
    profiler matches nothing; an unknown event_type raises ValueError."""
    table = table.view()
    d = table.dicts["stack"]
    etype_code = None
    if event_type is not None:
        etype_code = table.columns["event_type"].enum_of(event_type)
    svc_code = None
    if app_service is not None:
        svc_code = table.dicts["app_service"].lookup(app_service)
        if svc_code is None:
            return [], []
    prof_code = None
    if profiler is not None:
        prof_code = table.dicts["profiler"].lookup(profiler)
        if prof_code is None:
            return [], []
    sids, vals = [], []
    for ch in table.chunks:
        mask = np.ones(len(ch["stack"]), dtype=bool)
        if time_start_ns is not None:
            mask &= ch["time"] >= time_start_ns
        if time_end_ns is not None:
            mask &= ch["time"] < time_end_ns
        if etype_code is not None:
            mask &= ch["event_type"] == etype_code
        if svc_code is not None:
            mask &= ch["app_service"] == svc_code
        if prof_code is not None:
            mask &= ch["profiler"] == prof_code
        sids.append(ch["stack"][mask])
        vals.append(ch["value"][mask])
    if not sum(len(s) for s in sids):
        return [], []
    uniq, inv = np.unique(np.concatenate(sids), return_inverse=True)
    sums = np.bincount(inv, weights=np.concatenate(vals).astype(np.float64))
    return ([d.decode(sid) for sid in uniq.tolist()],
            [int(v) for v in sums.tolist()])


def merge_stack_values(parts: list[tuple[list, list]]) -> tuple[list, list]:
    """Sum several (stacks, values) aggregates by stack string."""
    agg: dict[str, int] = {}
    for stacks, values in parts:
        for s, v in zip(stacks, values):
            agg[s] = agg.get(s, 0) + int(v)
    return list(agg.keys()), list(agg.values())


def profile_flame_tree(table: ColumnarTable,
                       time_start_ns: int | None = None,
                       time_end_ns: int | None = None,
                       event_type: str | None = None,
                       app_service: str | None = None,
                       profiler: str | None = None) -> FlameNode:
    """Flame tree straight off the in_process_profile table."""
    stacks, values = profile_stack_values(
        table, time_start_ns=time_start_ns, time_end_ns=time_end_ns,
        event_type=event_type, app_service=app_service, profiler=profiler)
    return build_flame_tree(stacks, values)


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
