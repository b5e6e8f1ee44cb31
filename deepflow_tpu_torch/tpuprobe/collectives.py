"""Cross-device collective stitching.

Own copy of ``deepflow_tpu/tpuprobe/collectives.py`` with two changes
for NCCL; everything else is the reference's behaviour. Every device of
an SPMD step runs the same collective with the same run_id, so spans
group by (job, run_id, op, call); a group's latency is first entry to
last exit, and its skew (last start - first start) is the straggler
signal. Participants carry (host, slice) from the universal tags the
server injects and are host-qualified when a host tag is present.

- The call: XLA names each collective HLO apart (``all-reduce.11``), but
  every gradient bucket's all-reduce in a step runs an NCCL kernel of
  one name, and so do the calls of several communicators on one rank
  (a tensor-parallel and a data-parallel bf16 all-reduce). The Kineto
  parser puts the call's communicator and its ordinal in the step into
  ``program_id`` (``kineto.py``), equal on every rank of the mesh
  dimension for the same call, and the key takes it: one group per call
  of each communicator, whose participants are every rank that ran it,
  as the reference's one group per HLO is every device that ran it. XLA
  spans carry their program's id there, the same on every device of one
  program, so they group as the reference's.
- A group's ``replica_group_size`` is its members' (the communicator's
  size on NCCL spans, the HLO's replica groups on XLA ones), which the
  reference's per-slice split reads; ``to_dict`` keeps the reference's
  keys.
- The transport: a group whose participants sit on one host rides the
  node's NVLink (``"nvlink"``, the reference's ``"ici"``), one across
  hosts the network (``"network"``, the reference's ``"dcn"``). A node
  whose GPUs talk over PCIe only still reads ``"nvlink"``: the span rows
  carry no link type.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# pb.HOST_RUNTIME / pb.HOST_COMPILE as wire ints and as the store's enum
# strings — spans arrive here in both forms
_HOST_KINDS_INT = (4, 5)


def _is_host_plane(get) -> bool:
    """Host-side span (jax.monitoring hooks: compile / runtime events)?
    Host spans carry no device timeline; a capture holding only them has
    no device planes to bound a step with."""
    kind = get("kind")
    if isinstance(kind, str) and kind.startswith("host"):
        return True
    if isinstance(kind, int) and kind in _HOST_KINDS_INT:
        return True
    return str(get("hlo_category") or "") == "host"


@dataclass
class CollectiveGroup:
    """One collective instance stitched across its participants."""
    run_id: int
    hlo_op: str
    collective: str            # all-reduce | all-gather | ...
    job: str = ""              # tpu_pod / multislice job name
    participants: list = field(default_factory=list)  # "host:dev" or dev
    hosts: set = field(default_factory=set)
    slices: set = field(default_factory=set)
    start_ns: int = 0          # earliest entry
    end_ns: int = 0            # latest exit
    max_start_ns: int = 0      # latest entry
    min_duration_ns: int = 0
    max_duration_ns: int = 0
    bytes_transferred: int = 0  # per participant (same payload in SPMD)
    step: int = 0
    n_spans: int = 0  # > n_participants when the op repeats within a run
    replica_group_size: int = 0  # devices per replica group (0 = all)

    @property
    def latency_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def skew_ns(self) -> int:
        """Latest start minus earliest start: the straggler lag."""
        return self.max_start_ns - self.start_ns

    @property
    def transport(self) -> str:
        """network when participants span hosts; nvlink inside one."""
        return "network" if len(self.hosts) > 1 else "nvlink"

    def algo_bw_gbyte_s(self) -> float:
        """Algorithmic bandwidth in gigaBYTES/s: payload / group wall time."""
        lat = self.latency_ns
        if not lat or not self.bytes_transferred:
            return 0.0
        return self.bytes_transferred / lat  # bytes/ns == GB/s

    def to_dict(self) -> dict:
        return {
            "run_id": self.run_id,
            "hlo_op": self.hlo_op,
            "collective": self.collective,
            "job": self.job,
            "participants": sorted(self.participants),
            "n_participants": len(self.participants),
            "hosts": sorted(self.hosts),
            "slices": sorted(self.slices),
            "transport": self.transport,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "latency_ns": self.latency_ns,
            "skew_ns": self.skew_ns,
            "min_duration_ns": self.min_duration_ns,
            "max_duration_ns": self.max_duration_ns,
            "bytes_transferred": self.bytes_transferred,
            "algo_bw_gbyte_s": round(self.algo_bw_gbyte_s(), 3),
            "step": self.step,
            "n_spans": self.n_spans,
        }


def stitch(spans) -> list[CollectiveGroup]:
    """Group collective TpuSpanEvents (or row dicts) by
    (job, run_id, hlo_op, program_id), where job = tpu_pod tag
    (multi-host merge of span streams happens in the store; stitching
    must not merge two jobs whose run_id counters collide).

    Accepts objects with attrs or dicts with keys: run_id, hlo_op,
    program_id (the NCCL call's ordinal; 0 or the XLA program's id),
    collective, device_id, start_ns/time, duration_ns, bytes_transferred,
    step, and optionally host / slice_id / tpu_pod (ingest universal
    tags). Non-collective spans are ignored. Device identity is
    host-qualified when a host tag is present, so per-host device ids
    (TPU:0..3 on every worker) never collide across hosts.
    """
    # pass 1: collect deduped member rows per (job, run_id, op, call)
    collected: dict[tuple, list[dict]] = {}
    seen: dict[tuple, set] = {}       # group key -> exact-row dedup
    for s in spans:
        get = s.get if isinstance(s, dict) else lambda k, d=None: getattr(
            s, k, d)
        coll = get("collective") or ""
        if not coll:
            continue
        m = {
            "run_id": int(get("run_id") or 0),
            "op": str(get("hlo_op") or ""),
            "call": int(get("program_id") or 0),
            "coll": str(coll),
            "start": int(get("start_ns") or get("time") or 0),
            "dur": int(get("duration_ns") or 0),
            "dev": int(get("device_id") or 0),
            "core": int(get("core_id") or 0),
            "host": str(get("host") or ""),
            "slice": int(get("slice_id") or 0),
            "job": str(get("tpu_pod") or get("job") or ""),
            "bytes": int(get("bytes_transferred") or 0),
            "rgs": int(get("replica_group_size") or 0),
            "step": int(get("step") or 0),
        }
        key = (m["job"], m["run_id"], m["op"], m["call"])
        # drop only EXACT duplicate rows (re-ingested data); repeated
        # executions inside one run (lax.scan / grad accumulation) have
        # distinct starts and must all count
        row = (m["host"], m["dev"], m["core"], m["start"], m["dur"])
        rows_seen = seen.setdefault(key, set())
        if row in rows_seen:
            continue
        rows_seen.add(row)
        collected.setdefault(key, []).append(m)

    # pass 2: build groups, splitting a multi-slice span set into
    # per-slice (ICI) instances when the op's replica_group_size says
    # the collective is partitioned slice-locally — in one multislice
    # program, an in-slice reduce-scatter runs on EVERY slice with the
    # same run_id, and merging those into a fake "dcn" group would
    # misread per-slice ICI traffic as cross-slice DCN
    groups: list[CollectiveGroup] = []
    for (job, run_id, op, _call), members in collected.items():
        slices = {m["slice"] for m in members}
        rgs = max((m["rgs"] for m in members), default=0)
        n_parts = len({(m["host"], m["dev"], m["core"]) for m in members})
        split = False
        if len(slices) > 1 and 0 < rgs < n_parts:
            per_slice = {
                sl: len({(m["host"], m["dev"], m["core"])
                         for m in members if m["slice"] == sl})
                for sl in slices}
            # slice-local partitioning: every slice holds a whole number
            # of replica groups (covers sub-slice groups too, e.g. a
            # TP collective with rgs=2 on 4-device slices — labeling
            # that 'dcn' because it appears on both slices would be
            # affirmatively wrong)
            split = all(rgs <= c and c % rgs == 0
                        for c in per_slice.values())
        if split:
            for sl in sorted(slices):
                groups.append(_build_group(
                    job, run_id, op,
                    [m for m in members if m["slice"] == sl]))
        else:
            groups.append(_build_group(job, run_id, op, members))
    return sorted(groups, key=lambda g: (g.start_ns, g.hlo_op))


def _build_group(job: str, run_id: int, op: str,
                 members: list[dict]) -> CollectiveGroup:
    first = members[0]
    g = CollectiveGroup(
        run_id=run_id, hlo_op=op, collective=first["coll"], job=job,
        start_ns=min(m["start"] for m in members),
        end_ns=max(m["start"] + m["dur"] for m in members),
        max_start_ns=max(m["start"] for m in members),
        min_duration_ns=min(m["dur"] for m in members),
        max_duration_ns=max(m["dur"] for m in members),
        bytes_transferred=first["bytes"],
        step=first["step"], n_spans=len(members),
        replica_group_size=max(m["rgs"] for m in members))
    seen_parts: set = set()
    for m in members:
        ident = (m["host"], m["dev"], m["core"])
        if ident not in seen_parts:
            seen_parts.add(ident)
            # host-qualified or bare, but ALWAYS str: a group mixing
            # tagged and untagged rows must stay sortable in to_dict
            g.participants.append(
                f"{m['host']}:{m['dev']}" if m["host"] else str(m["dev"]))
        if m["host"]:
            g.hosts.add(m["host"])
        g.slices.add(m["slice"])
    return g


def step_trace(spans, run_id: int | None = None) -> dict:
    """One step's cross-device picture: module span bounds per device plus
    stitched collectives — the 'is my step bound by compute, collectives,
    or a straggler?' view. Multi-host aware: runs group by (job, run_id)
    like stitch(), and devices key by host-qualified id so worker-0's
    TPU:0 and worker-1's TPU:0 stay distinct.

    Degraded captures never raise: None / empty input, or spans with NO
    device planes (e.g. host-only hook events from a partial capture),
    return the zeroed dict — host spans would otherwise fabricate a
    device-"0" plane whenever they carry a run_id."""
    by_run: dict[tuple, list] = {}
    for s in spans or ():
        get = s.get if isinstance(s, dict) else lambda k, d=None: getattr(
            s, k, d)
        if _is_host_plane(get):
            continue
        rid = int(get("run_id") or 0)
        if rid and (run_id is None or rid == run_id):
            job = str(get("tpu_pod") or get("job") or "")
            by_run.setdefault((job, rid), []).append(s)
    if not by_run:
        return {"run_id": 0, "job": "", "devices": {}, "collectives": [],
                "step_latency_ns": 0, "device_skew_ns": 0}
    job, rid = max(by_run, key=lambda k: len(by_run[k]))
    rows = by_run[(job, rid)]
    devices: dict[str, dict] = {}
    for s in rows:
        get = s.get if isinstance(s, dict) else lambda k, d=None: getattr(
            s, k, d)
        dev = int(get("device_id") or 0)
        host = str(get("host") or "")
        key = f"{host}:{dev}" if host else str(dev)
        start = int(get("start_ns") or get("time") or 0)
        end = start + int(get("duration_ns") or 0)
        d = devices.setdefault(key, {
            "start_ns": start, "end_ns": end, "compute_ns": 0,
            "collective_ns": 0, "n_spans": 0})
        d["start_ns"] = min(d["start_ns"], start)
        d["end_ns"] = max(d["end_ns"], end)
        d["n_spans"] += 1
        dur = int(get("duration_ns") or 0)
        if get("collective"):
            d["collective_ns"] += dur
        elif get("hlo_op"):
            d["compute_ns"] += dur
    colls = [g.to_dict() for g in stitch(rows)]
    ends = [d["end_ns"] for d in devices.values()]
    starts = [d["start_ns"] for d in devices.values()]
    return {
        "run_id": rid,
        "job": job,
        "devices": devices,
        "collectives": colls,
        "step_latency_ns": (max(ends) - min(starts)) if devices else 0,
        "device_skew_ns": (max(ends) - min(ends)) if devices else 0,
    }
