"""NCCL collectives observed across the ranks of a data-parallel job, held
against the JAX package on the CPU.

Each rank is its own process with its own capture: the port parses one
synthetic Kineto trace per rank (``kineto_synth.synth_dp_ranks``: every
gradient bucket's all-reduce runs one NCCL kernel name), and the
reference parses one XSpace of the same calls with a distinct XLA op name
per call. The port's stitcher must find the reference's groups (start,
end, skew, participants), one per call; rows re-ingested are deduped and
repeated calls kept; ranks stay apart when each sees its GPU as ordinal 0;
hosts tell NVLink from the network; the port's server merges several
agents' rows through ``AgentInfo`` as the reference's does; the step
health view names the straggler rank; and the ranks' agents, each under
its own id, land every row exactly once. On a model-parallel mesh
(``kineto_synth.synth_mesh_ranks``, each rank's call log beside its
capture) the port's groups are the reference's of the ``xla_names``
twins: one per call of each communicator, every rank a participant, the
communicator's size as ``replica_group_size``.
"""

import json
import math
import socket
import time

import pytest

from deepflow_tpu.server import Server as RefServer
from deepflow_tpu.server import stephealth as ref_stephealth
from deepflow_tpu.server.platform_info import AgentInfo as RefAgentInfo
from deepflow_tpu.tpuprobe import collectives as rc
from deepflow_tpu.tpuprobe import xplane, xplane_synth
from deepflow_tpu.tpuprobe.events import batch_to_pb as ref_batch_to_pb
from deepflow_tpu_torch.agent.agent import Agent
from deepflow_tpu_torch.agent.config import AgentConfig
from deepflow_tpu_torch.codec import FrameHeader, MessageType, encode_frame
from deepflow_tpu_torch.server import Server
from deepflow_tpu_torch.server import stephealth
from deepflow_tpu_torch.server.platform_info import AgentInfo
from deepflow_tpu_torch.tpuprobe import collectives as tc
from deepflow_tpu_torch.tpuprobe import kineto, kineto_synth, ranks
from deepflow_tpu_torch.tpuprobe.events import batch_to_pb
from deepflow_tpu_torch.tpuprobe.stepmetrics import (
    StepAggregator, encode_step_payload)

BASE_NS = 1_760_000_000_000_000_000
TRANSPORT = {"ici": "nvlink", "dcn": "network"}
# the group fields both stitchers must agree on (hlo_op differs by
# design: one NCCL name per dtype against one XLA name per call; step is
# 0 in the reference's xplane spans)
SAME = ("run_id", "collective", "job", "participants", "n_participants",
        "hosts", "slices", "start_ns", "end_ns", "latency_ns", "skew_ns",
        "min_duration_ns", "max_duration_ns", "bytes_transferred",
        "algo_bw_gbyte_s", "n_spans")


def _port_spans(spec, ordinal=None, with_rank=True):
    """Each rank's capture parsed on its own, as its probe parses it:
    the rank's GPU is its local ordinal (``ordinal`` for all, as under a
    launcher that sets CUDA_VISIBLE_DEVICES per rank)."""
    out = {}
    for r, mods in spec.items():
        trace, hooks = kineto_synth.build_trace(
            {r if ordinal is None else ordinal: mods}, base_ns=BASE_NS)
        out[r] = kineto.extract_device_spans(
            trace, hooks, rank=r if with_rank else None)
    return out


def _xla(spec):
    """The kineto_synth spec as the reference's xplane_synth spec."""
    return {r: [xplane_synth.SynthModule(
        m.name, m.run_id, m.offset_ps, m.duration_ps,
        [xplane_synth.SynthOp(o.name, o.category, o.offset_ps, o.duration_ps,
                              o.flops, o.bytes_accessed,
                              o.replica_group_size) for o in m.ops])
        for m in mods] for r, mods in spec.items()}


def _ref_spans(kw, devices=None):
    """The reference's spans of the same calls, distinct op names, from
    one XSpace per host (``devices``: host -> ranks; one host default)."""
    spec = _xla(kineto_synth.synth_dp_ranks(xla_names=True, **kw))
    hosts = devices or {"": list(spec)}
    return {host: xplane.extract_device_spans(
        xplane.parse_xspace(xplane_synth.build_xspace(
            {r: spec[r] for r in rs})), capture_start_ns=BASE_NS)
        for host, rs in hosts.items()}


def _same(group: dict) -> dict:
    return {k: group[k] for k in SAME}


def _flat(by_rank):
    return [s for spans in by_rank.values() for s in spans]


@pytest.mark.parametrize("n_ranks,n_buckets", [(2, 3), (4, 3), (4, 1)])
def test_each_call_stitches_into_its_own_group(n_ranks, n_buckets):
    """Every bucket's all-reduce and the loss's of every step is one group
    with all ranks as participants, equal to the reference's group of the
    same call."""
    kw = dict(n_ranks=n_ranks, n_buckets=n_buckets, n_steps=3, straggler=1)
    port = tc.stitch(_flat(_port_spans(kineto_synth.synth_dp_ranks(**kw))))
    ref = rc.stitch(_ref_spans(kw)[""])
    assert len(port) == len(ref) == 3 * (n_buckets + 1)
    for g in port:
        assert g.n_spans == n_ranks
        assert sorted(g.participants) == [str(r) for r in range(n_ranks)]
        assert g.transport == "nvlink"
    got = [_same(g.to_dict()) for g in port]
    want = [_same(g.to_dict()) for g in ref]
    assert got == want
    # the dict keeps exactly the reference's keys
    assert list(port[0].to_dict()) == list(ref[0].to_dict())
    # the calls of a step, in order: their ordinal rides program_id
    first = [g for g in port if g.run_id == 1000]
    assert [g.hlo_op for g in first] == \
        [kineto_synth.NCCL_ALLREDUCE["BFloat16"]] * n_buckets + \
        [kineto_synth.NCCL_ALLREDUCE["Float"]]
    # the straggler (rank 1, 400 ns late, 50 ns of skew) arrives last at
    # the first call
    assert first[0].skew_ns == 450


def test_nccl_spans_carry_call_size_rank_and_ordinal():
    spec = kineto_synth.synth_dp_ranks(n_ranks=2, n_buckets=2, n_steps=2)
    by_rank = _port_spans(spec, ordinal=0)
    for r, spans in by_rank.items():
        nccl = [s for s in spans if s.collective]
        assert [(s.run_id, s.program_id) for s in nccl] == \
            [(1000, 1), (1000, 2), (1000, 3), (1001, 1), (1001, 2),
             (1001, 3)]
        assert {s.device_id for s in spans} == {r}
        assert {s.chip_id for s in spans} == {0}
        # the size where the capture has it (In msg nelems x dtype)
        assert [s.bytes_transferred for s in nccl[:3]] == \
            [26_214_400, 26_214_400, 4]
        assert all(s.program_id == 0 for s in spans if not s.collective)


def test_steps_stitch_like_the_reference():
    kw = dict(n_ranks=4, n_buckets=3, n_steps=2, straggler=3)
    port = _flat(_port_spans(kineto_synth.synth_dp_ranks(**kw)))
    ref = _ref_spans(kw)[""]
    for run_id in (1000, 1001):
        got = tc.step_trace(port, run_id)
        want = rc.step_trace(ref, run_id)
        assert got["devices"] == want["devices"]
        for k in ("run_id", "job", "step_latency_ns", "device_skew_ns"):
            assert got[k] == want[k], k
        assert [_same(g) for g in got["collectives"]] == \
            [_same(dict(g, transport=TRANSPORT[g["transport"]]))
             for g in want["collectives"]]


def test_duplicate_rows_deduped_and_repeated_calls_kept():
    """Rows ingested twice add nothing; two calls of one kernel name in a
    step stay two groups, and a span set without the call ordinal (the
    key before NCCL) merges them into one."""
    spec = kineto_synth.synth_dp_ranks(n_ranks=2, n_buckets=3, n_steps=1)
    spans = _flat(_port_spans(spec))
    rows = [{"time": s.start_ns, "duration_ns": s.duration_ns,
             "device_id": s.device_id, "core_id": s.core_id,
             "hlo_op": s.hlo_op, "program_id": s.program_id,
             "collective": s.collective, "run_id": s.run_id,
             "bytes_transferred": s.bytes_transferred, "step": s.step}
            for s in spans]
    once = [g.to_dict() for g in tc.stitch(rows)]
    twice = [g.to_dict() for g in tc.stitch(rows + rows)]
    assert once == twice and len(once) == 4
    assert all(g["n_spans"] == 2 for g in once)
    merged = tc.stitch([dict(r, program_id=0) for r in rows])
    # without the ordinal the three bf16 buckets are one "collective"
    # from the first bucket's start to the last one's end
    assert len(merged) == 2
    bf16 = [g for g in merged if "bf16" in g.hlo_op][0]
    assert bf16.n_spans == 6
    assert bf16.latency_ns == once[2]["end_ns"] - once[0]["start_ns"]


def test_ranks_with_one_visible_gpu_each_do_not_collide():
    """A launcher that sets CUDA_VISIBLE_DEVICES per rank makes every
    local ordinal 0: the spans' device_id is the global rank, so the
    groups keep every rank; keyed by the ordinal they collapse to one
    participant."""
    spec = kineto_synth.synth_dp_ranks(n_ranks=4, n_buckets=2, n_steps=1)
    good = tc.stitch(_flat(_port_spans(spec, ordinal=0)))
    assert all(sorted(g.participants) == ["0", "1", "2", "3"] for g in good)
    bad = tc.stitch(_flat(_port_spans(spec, ordinal=0, with_rank=False)))
    assert all(g.participants == ["0"] for g in bad)
    # and ranks whose calls ended alike read as re-ingested rows: dropped
    assert min(g.n_spans for g in bad) == 1


def _tagged(by_rank, host_of, job):
    rows = []
    for r, spans in by_rank.items():
        for s in spans:
            rows.append({
                "time": s.start_ns, "duration_ns": s.duration_ns,
                "device_id": s.device_id, "core_id": s.core_id,
                "hlo_op": s.hlo_op, "program_id": s.program_id,
                "collective": s.collective, "run_id": s.run_id,
                "bytes_transferred": s.bytes_transferred, "step": s.step,
                "host": host_of[r], "slice_id": int(host_of[r][-1]),
                "tpu_pod": job})
    return rows


def test_transport_nvlink_inside_a_host_network_across():
    """Participants on one host ride NVLink, across hosts the network:
    the reference's ici / dcn for the same hosts and slices."""
    kw = dict(n_ranks=4, n_buckets=2, n_steps=1)
    by_rank = _port_spans(kineto_synth.synth_dp_ranks(**kw))
    for hosts in ({0: "node-0", 1: "node-0", 2: "node-0", 3: "node-0"},
                  {0: "node-0", 1: "node-0", 2: "node-1", 3: "node-1"}):
        port = tc.stitch(_tagged(by_rank, hosts, "dp"))
        ref_rows = []
        ref_by_host = _ref_spans(kw, devices={
            h: [r for r in hosts if hosts[r] == h]
            for h in sorted(set(hosts.values()))})
        for h, spans in ref_by_host.items():
            ref_rows += [{"time": s.start_ns, "duration_ns": s.duration_ns,
                          "device_id": s.device_id, "core_id": s.core_id,
                          "hlo_op": s.hlo_op, "collective": s.collective,
                          "run_id": s.run_id,
                          "bytes_transferred": s.bytes_transferred,
                          "host": h, "slice_id": int(h[-1]), "tpu_pod": "dp"}
                         for s in spans]
        ref = rc.stitch(ref_rows)
        assert [g.transport for g in port] == \
            [TRANSPORT[g.transport] for g in ref]
        want = "network" if len(set(hosts.values())) > 1 else "nvlink"
        assert {g.transport for g in port} == {want}
        assert [_same(g.to_dict()) for g in port] == \
            [_same(g.to_dict()) for g in ref]
        assert "node-0:0" in port[0].participants


def _post(port, path, body=None):
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.load(r)["result"]


def _ship(port, frames):
    with socket.create_connection(("127.0.0.1", port), timeout=5) as c:
        c.sendall(b"".join(frames))


def test_port_server_multihost_merge():
    """The port's counterpart of the reference's server-side multi-host
    merge: four ranks' agents on two hosts, registered through AgentInfo,
    ship their span batches; TpuCollectives gives one network group per
    call with host-qualified ranks, a job on one host nvlink groups, and
    both servers answer alike (ici / dcn read as nvlink / network)."""
    kw = dict(n_ranks=4, n_buckets=3, n_steps=2, straggler=2)
    by_rank = _port_spans(kineto_synth.synth_dp_ranks(**kw))
    hosts = {0: "node-0", 1: "node-0", 2: "node-1", 3: "node-1"}
    ref_by_host = _ref_spans(kw, devices={"node-0": [0, 1],
                                          "node-1": [2, 3]})
    port = Server(ingest_port=0, query_port=0,
                  selfstats_interval_s=3600).start()
    ref = RefServer(host="127.0.0.1", ingest_port=0, query_port=0,
                    selfstats_interval_s=3600).start()
    try:
        total = 0
        for r, spans in by_rank.items():
            aid = ranks.agent_id_for_rank(r)
            port.platform.update(AgentInfo(
                agent_id=aid, host=hosts[r], tpu_pod="dp-job",
                tpu_worker=r, slice_id=int(hosts[r][-1])))
            _ship(port.ingest_port, [encode_frame(
                FrameHeader(MessageType.TPU_SPAN, agent_id=aid),
                batch_to_pb(spans, pid=100 + r, process_name="train"))])
            total += len(spans)
        ref_total = 0
        for sl, (host, spans) in enumerate(sorted(ref_by_host.items())):
            ref.platform.update(RefAgentInfo(
                agent_id=sl + 1, host=host, tpu_pod="dp-job",
                tpu_worker=sl, slice_id=sl))
            from deepflow_tpu.codec import FrameHeader as RH, \
                MessageType as RM, encode_frame as ref_encode
            _ship(ref.ingest_port, [ref_encode(
                RH(RM.TPU_SPAN, agent_id=sl + 1),
                ref_batch_to_pb(spans, pid=100 + sl,
                                process_name="train").SerializeToString())])
            ref_total += len(spans)
        assert port.wait_for_rows("profile.tpu_hlo_span", total, timeout=10)
        assert ref.wait_for_rows("profile.tpu_hlo_span", ref_total,
                                 timeout=10)
        groups = _post(port.query_port, "/v1/profile/TpuCollectives")
        assert len(groups) == 2 * 4
        for g in groups:
            assert g["transport"] == "network" and g["job"] == "dp-job"
            assert g["participants"] == ["node-0:0", "node-0:1",
                                         "node-1:2", "node-1:3"]
            assert g["hosts"] == ["node-0", "node-1"]
            assert g["slices"] == [0, 1]
        want = _post(ref.query_port, "/v1/profile/TpuCollectives")
        assert [_same(g) for g in groups] == [
            _same(dict(g, transport=TRANSPORT[g["transport"]]))
            for g in want]
        trace = _post(port.query_port, "/v1/profile/TpuStepTrace",
                      {"run_id": 1001})
        ref_trace = _post(ref.query_port, "/v1/profile/TpuStepTrace",
                          {"run_id": 1001})
        assert set(trace["devices"]) == {"node-0:0", "node-0:1",
                                         "node-1:2", "node-1:3"}
        assert trace["devices"] == ref_trace["devices"]
        assert trace["device_skew_ns"] == ref_trace["device_skew_ns"] > 0

        # a second job of two ranks on one host: nvlink
        local = _port_spans(kineto_synth.synth_dp_ranks(
            n_ranks=2, n_buckets=1, n_steps=1))
        for r, spans in local.items():
            aid = 100 + r
            port.platform.update(AgentInfo(
                agent_id=aid, host="node-2", tpu_pod="local-job",
                slice_id=2))
            _ship(port.ingest_port, [encode_frame(
                FrameHeader(MessageType.TPU_SPAN, agent_id=aid),
                batch_to_pb(spans, pid=200 + r, process_name="train"))])
            total += len(spans)
        assert port.wait_for_rows("profile.tpu_hlo_span", total, timeout=10)
        groups = _post(port.query_port, "/v1/profile/TpuCollectives")
        mine = [g for g in groups if g["job"] == "local-job"]
        assert len(mine) == 2
        assert all(g["transport"] == "nvlink" and g["participants"] ==
                   ["node-2:0", "node-2:1"] for g in mine)
        assert port.platform.query(1).host_id != \
            port.platform.query(3).host_id
        assert port.platform.tags_for(99) == {"agent_id": 99, "org_id": 1}
    finally:
        port.stop()
        ref.stop()


def test_step_health_names_the_straggler_rank():
    """Each rank's probe folds its spans into step records; merged across
    the ranks, /v1/tpu/steps names the straggler rank, as the reference's
    step health does on the same rows."""
    kw = dict(n_ranks=4, n_buckets=2, n_steps=3, straggler=2)
    by_rank = _port_spans(kineto_synth.synth_dp_ranks(**kw))
    port = Server(ingest_port=0, query_port=0,
                  selfstats_interval_s=3600).start()
    try:
        for r, spans in by_rank.items():
            records = []
            agg = StepAggregator(records.extend)
            agg.feed(spans)
            agg.flush()
            assert {rec["straggler_device"] for rec in records} == {r}
            _ship(port.ingest_port, [encode_frame(
                FrameHeader(MessageType.STEP_METRICS,
                            agent_id=ranks.agent_id_for_rank(r)),
                encode_step_payload(records, pid=r, process_name="train"))])
        assert port.wait_for_rows("profile.tpu_step_metrics", 4 * 3)
        steps = _post(port.query_port, "/v1/tpu/steps")["steps"]
        assert len(steps) == 3
        assert all(s["straggler_device"] == 2 and s["device_count"] == 4
                   and s["records"] == 4 for s in steps)
        # the same rows through both step-health merges
        tab = port.db.table("profile.tpu_step_metrics")
        names = ["time", "end_ns", "latency_ns", "run_id", "step", "job",
                 "device_count", "device_skew_ns", "compute_ns",
                 "collective_ns", "straggler_device", "straggler_lag_ns",
                 "top_hlos", "host"]
        cols = tab.column_concat(names)
        dec = [tab.dicts[n].decode_many(cols[n]) if n in tab.dicts
               else cols[n].tolist() for n in names]
        rows = [dict(zip(names, row)) for row in zip(*dec)]
        assert stephealth.merge_host_partials(rows) == \
            ref_stephealth.merge_host_partials(rows)
        assert stephealth.score_timeline(
            stephealth.merge_host_partials(rows)) == \
            ref_stephealth.score_timeline(
                ref_stephealth.merge_host_partials(rows))
    finally:
        port.stop()


# -- one agent per rank --------------------------------------------------------------

def test_launcher_rank_gives_each_agent_its_own_id(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert AgentConfig().agent_id == 0          # no launcher: unchanged
    ids = []
    for rank in range(4):
        monkeypatch.setenv("RANK", str(rank))
        monkeypatch.setenv("WORLD_SIZE", "4")
        monkeypatch.setenv("LOCAL_RANK", str(rank % 2))
        ids.append(AgentConfig().agent_id)
        assert AgentConfig().agent_id == ids[-1]   # stable for the rank
        assert AgentConfig(agent_id=7).agent_id == 7   # explicit wins
    assert ids == [1, 2, 3, 4]
    assert ranks.agent_id_for_rank(65_534) == 65_535
    assert ranks.agent_id_for_rank(65_535) == 1     # stays in the u16
    monkeypatch.setenv("RANK", "x")
    assert AgentConfig().agent_id == 0
    with pytest.raises(ValueError):
        AgentConfig(agent_id=65_536).validate()


def _rank_agent(server, monkeypatch, rank, agent_id=None):
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", str(rank))
    cfg = AgentConfig(app_service="dp-train", stats_interval_s=3600)
    if agent_id is not None:
        cfg.agent_id = agent_id
    cfg.profiler.enabled = False
    cfg.guard.enabled = False
    cfg.sender.servers = [("127.0.0.1", server.ingest_port)]
    return Agent(cfg, device="cpu")


def _span_batch(rank, i):
    spec = kineto_synth.synth_dp_ranks(n_ranks=2, n_buckets=1, n_steps=1)
    trace, hooks = kineto_synth.build_trace({0: spec[rank]},
                                            base_ns=BASE_NS + i * 10**9)
    spans = kineto.extract_device_spans(trace, hooks, rank=rank)
    return batch_to_pb(spans, pid=rank, process_name="train"), len(spans)


def _two_ranks_ship(server, monkeypatch, ids):
    """Rank 0's agent is made first; rank 1's, made later, has the later
    sequence epoch and ships first, then rank 0 ships. Returns the span
    rows each rank sent."""
    a0 = _rank_agent(server, monkeypatch, 0, ids[0])
    time.sleep(0.01)  # the later agent's seqs start above the earlier's
    a1 = _rank_agent(server, monkeypatch, 1, ids[1])
    sent = {}
    for rank, agent in ((1, a1), (0, a0)):
        agent.start()
        n = 0
        for i in range(5):
            payload, k = _span_batch(rank, i)
            assert agent.send_tpu_spans(payload)
            n += k
        agent.sender.flush(5.0)
        sent[rank] = n
    for agent in (a0, a1):
        agent.stop()
    return sent


def test_two_ranks_agents_land_every_row_once(monkeypatch):
    """Both ranks' agents at agent_id 0 share one dedup floor: the rank
    that ships second loses its frames as duplicates. Under the
    launcher's ids every row of both lands exactly once."""
    lost = Server(ingest_port=0, query_port=0,
                  selfstats_interval_s=3600).start()
    try:
        sent = _two_ranks_ship(lost, monkeypatch, (0, 0))
        time.sleep(0.5)
        assert len(lost.db.table("profile.tpu_hlo_span")) == sent[1]
        assert lost.dedup.stats["dups"] >= 5
    finally:
        lost.stop()
    srv = Server(ingest_port=0, query_port=0,
                 selfstats_interval_s=3600).start()
    try:
        sent = _two_ranks_ship(srv, monkeypatch, (None, None))
        total = sent[0] + sent[1]
        assert srv.wait_for_rows("profile.tpu_hlo_span", total)
        time.sleep(0.3)
        tab = srv.db.table("profile.tpu_hlo_span")
        assert len(tab) == total
        cols = tab.column_concat(["agent_id", "device_id"])
        per = {}
        for aid, dev in zip(cols["agent_id"].tolist(),
                            cols["device_id"].tolist()):
            per.setdefault(aid, set()).add(dev)
        assert per == {1: {0}, 2: {1}}
        assert sum(cols["agent_id"] == 1) == sent[0]
        assert srv.dedup.stats["dups"] == 0
        assert all(d.stats["dups"] == 0 for d in srv.decoders)
        # each agent's self-stats rows carry its rank
        st = srv.db.table("deepflow_system.deepflow_system")
        scols = st.column_concat(["agent_id", "tag_json"])
        tags = {(a, json.loads(st.dicts["tag_json"].decode(t)).get("rank"))
                for a, t in zip(scols["agent_id"].tolist(),
                                scols["tag_json"].tolist())}
        assert tags == {(1, "0"), (2, "1")}
    finally:
        srv.stop()


def test_memory_samples_take_the_spans_device_id(monkeypatch):
    """A rank's memory samples carry its global rank, as its spans do;
    a lone process keeps the CUDA ordinal."""
    import torch

    from deepflow_tpu_torch.tpuprobe.sources import MemorySource

    stats = {"reserved_bytes.all.current": 8 << 30,
             "allocated_bytes.all.current": 5 << 30,
             "allocated_bytes.all.peak": 6 << 30,
             "allocation.all.current": 42}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats)
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: [])
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (70 << 30, 80 << 30))
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert [s["device_id"] for s in MemorySource(list).poll_once()] == [0]
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "0")
    got = MemorySource(list).poll_once()
    assert [(s["device_id"], s["bytes_in_use"]) for s in got] == \
        [(3, 5 << 30)]


def test_runner_agent_id_flag_overrides_the_rank(monkeypatch):
    from deepflow_tpu_torch.cli import runner

    got = []
    monkeypatch.setattr(runner, "attach",
                        lambda **kw: got.append(kw))
    monkeypatch.setattr(runner, "detach", lambda: None)
    monkeypatch.setattr(runner.runpy, "run_module", lambda *a, **k: None)
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert runner.main(["--device", "cpu", "-m", "x"]) == 0
    assert runner.main(["--device", "cpu", "--agent-id", "9", "-m",
                        "x"]) == 0
    assert "agent_id" not in got[0]         # the config's default: rank + 1
    assert got[1]["agent_id"] == 9


def test_ranks_open_and_close_captures_at_the_same_steps(monkeypatch):
    """Under a launcher with more than one rank, a capture's session
    opens at a step numbered a multiple of the cycle's period and closes
    steps_per_capture steps later, both while the step is held, so ranks
    in lockstep hold together and capture the same whole steps; a lone
    process holds the next step."""
    import json as _json
    import threading

    import torch.profiler as tp

    from deepflow_tpu_torch.tpuprobe import sources as S

    def run(world):
        for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            monkeypatch.delenv(name, raising=False)
        if world > 1:
            monkeypatch.setenv("RANK", "1")
            monkeypatch.setenv("WORLD_SIZE", str(world))
        src = S.KinetoSource(lambda e: None, interval_s=0.3, duration_ms=50,
                             steps_per_capture=7)
        at = []

        class FakeProfile:
            def __init__(self, activities):
                pass

            def start(self):
                at.append(src.step_hook.count)

            def stop(self):
                at.append(src.step_hook.count)

            def export_chrome_trace(self, path):
                with open(path, "w") as f:
                    _json.dump({"traceEvents": []}, f)
        monkeypatch.setattr(tp, "profile", FakeProfile)
        done = threading.Event()

        def stepper():
            while not done.is_set():
                src.step_hook._on_step(None, (), {})
                time.sleep(0.002)
        t = threading.Thread(target=stepper)
        src.step_hook._on_step(None, (), {})   # step 1: steps are seen
        t.start()
        try:
            src.capture_once()
        finally:
            done.set()
            t.join()
        return at, src.stats

    # the cycle is 7 * 2 steps at the default coverage of one half
    at, stats = run(world=4)
    assert stats["period_steps"] == 14 and stats["unheld"] == 0
    assert len(at) == 2 and at[0] % 14 == 0 and at[1] == at[0] + 7
    at, stats = run(world=1)
    assert stats["period_steps"] == 0 and stats["unheld"] == 0


def test_capture_stops_on_the_workloads_device(monkeypatch):
    """The probe's thread opens and closes its session with the device
    the workload holds memory on as its current one: a session's stop
    synchronizes the calling thread's current device, device 0 in a
    thread that never chose one. The step held at the stop, whose
    kernels were launched just before it, is left out of the spans."""
    import json as _json
    import threading

    import torch
    import torch.profiler as tp

    from deepflow_tpu_torch.tpuprobe import sources as S

    calls = []
    current = {"dev": 0}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(
        torch.cuda, "memory_stats",
        lambda i: {"reserved_bytes.all.current": 1 << 30} if i == 2 else {})
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: current.update(dev=i))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current["dev"])
    src = S.KinetoSource(lambda e: None, interval_s=0.3, duration_ms=60)

    class FakeProfile:
        def __init__(self, activities):
            pass

        def start(self):
            calls.append(("start", current["dev"], src.step_hook.count))

        def stop(self):
            calls.append(("stop", current["dev"], src.step_hook.count))

        def export_chrome_trace(self, path):
            # one kernel launched in each step since the start, the held
            # step's included (launched before its mark)
            events = []
            for i, (step, t) in enumerate(src.step_hook.since(0)):
                if step <= calls[0][2]:
                    continue
                for cat, ts, corr in (("kernel", t + 1000, 2 * i),
                                      ("cuda_runtime", t - 1000, 2 * i)):
                    events.append({"ph": "X", "cat": cat, "name": "k",
                                   "ts": ts / 1000, "dur": 0.5, "args": {
                                       "device": 2, "stream": 7,
                                       "correlation": corr}})
            with open(path, "w") as f:
                _json.dump({"traceEvents": events}, f)
    monkeypatch.setattr(tp, "profile", FakeProfile)
    src.step_hook._on_step(None, (), {})
    done = threading.Event()

    def stepper():
        while not done.is_set():
            src.step_hook._on_step(None, (), {})
            time.sleep(0.002)
    t = threading.Thread(target=stepper)
    t.start()
    try:
        spans = src.capture_once()
    finally:
        done.set()
        t.join()
    (_, d0, first), (_, d1, held) = calls
    assert (d0, d1) == (2, 2) and held > first + 1
    kernel_steps = sorted({s.run_id for s in spans if s.hlo_op})
    assert kernel_steps == list(range(first + 1, held))
    assert src.stats["events"] == len(spans)
    assert S.workload_devices() == [2]


# -- several communicators on one rank (a model-parallel mesh) ------------

MESH_CASES = [((1, 2, 2), ("data", "fsdp", "tensor")),
              ((2, 1, 2), ("data", "fsdp", "tensor")),
              ((2, 2), ("data", "sp"))]
# the port's name of each XLA collective (the reference's ppermute)
PORT_COLLECTIVE = {"collective-permute": "send-recv"}


def _mesh_port_spans(spec, shape, axes, calls=True):
    """Each rank's capture parsed as its probe parses it, with its call
    log (``calls``) or without one."""
    from deepflow_tpu_torch.tpuprobe.comms import comm_id
    sizes = {comm_id(a): n for a, n in zip(axes, shape)}
    out = {}
    for r, mods in spec.items():
        trace, hooks = kineto_synth.build_trace({r: mods}, base_ns=BASE_NS)
        out[r] = kineto.extract_device_spans(
            trace, hooks, rank=r,
            calls=kineto_synth.call_windows(mods, BASE_NS) if calls else (),
            comm_sizes=sizes, world=len(spec))
    return out


def _mesh_ref_spans(shape, axes):
    spec = _xla(kineto_synth.synth_mesh_ranks(shape, axes, xla_names=True))
    return xplane.extract_device_spans(
        xplane.parse_xspace(xplane_synth.build_xspace(spec)),
        capture_start_ns=BASE_NS)


@pytest.mark.parametrize("shape,axes", MESH_CASES, ids=str)
def test_mesh_calls_stitch_per_communicator(shape, axes):
    """One group per call of each communicator, with every rank of the
    mesh as a participant and the communicator's size as its
    replica_group_size: the reference's groups of the same calls, where
    each collective HLO with replica groups runs on every device."""
    port = tc.stitch(_flat(_mesh_port_spans(
        kineto_synth.synth_mesh_ranks(shape, axes), shape, axes)))
    ref_spans = _mesh_ref_spans(shape, axes)
    ref = rc.stitch(ref_spans)
    n = math.prod(shape)
    assert len(port) == len(ref) > 0
    ref_rgs = {s.hlo_op: s.replica_group_size for s in ref_spans
               if s.collective}
    sizes = dict(zip(axes, shape))
    from deepflow_tpu_torch.tpuprobe.comms import CALL_STRIDE, comm_axis
    program = {}
    for s in _flat(_mesh_port_spans(
            kineto_synth.synth_mesh_ranks(shape, axes), shape, axes)):
        if s.collective:
            program.setdefault((s.run_id, s.start_ns), s.program_id)
    for g, w in zip(port, ref):
        assert sorted(g.participants) == [str(r) for r in range(n)]
        assert g.n_spans == n
        assert g.replica_group_size == ref_rgs[w.hlo_op]
        axis = comm_axis(program[(g.run_id, g.start_ns)] // CALL_STRIDE)
        assert g.replica_group_size == sizes[axis]
    assert [_same(g.to_dict()) for g in port] == [
        _same(dict(g.to_dict(), collective=PORT_COLLECTIVE.get(
            g.collective, g.collective))) for g in ref]


def test_two_communicators_with_one_kernel_name_do_not_merge():
    """On a (2, 1, 2) mesh each rank's first tensor all-reduce and its
    first data all-reduce run one bf16 NCCL kernel name. Issued
    asynchronously each runs on its communicator's own stream, as call
    1 of that stream: keyed by the communicator they are two groups;
    keyed by the ordinal on the stream (the key before communicators)
    they merge into one "collective" of eight spans."""
    from deepflow_tpu_torch.tpuprobe.comms import CALL_STRIDE
    shape, axes = (2, 1, 2), ("data", "fsdp", "tensor")
    spec = kineto_synth.synth_mesh_ranks(shape, axes, n_steps=1)
    for mods in spec.values():   # each communicator's own stream
        for m in mods:
            for op in m.ops:
                if op.comm:
                    op.stream = 13 + 4 * len(op.comm)
    spans = _flat(_mesh_port_spans(spec, shape, axes))
    bf16 = kineto_synth.NCCL_ALLREDUCE["BFloat16"]
    first = [s for s in spans if s.hlo_op == bf16
             and s.program_id % CALL_STRIDE == 1]
    assert {s.program_id // CALL_STRIDE for s in first} == {1, 3}
    assert len({s.core_id for s in first}) == 2
    groups = [g for g in tc.stitch(spans) if g.hlo_op == bf16]
    assert all(g.n_spans == 4 and len(set(g.participants)) == 4
               for g in groups)
    old = tc.stitch([dict(
        time=s.start_ns, duration_ns=s.duration_ns, device_id=s.device_id,
        core_id=s.core_id, hlo_op=s.hlo_op, collective=s.collective,
        run_id=s.run_id, program_id=s.program_id % CALL_STRIDE)
        for s in spans])
    merged = [g for g in old if g.hlo_op == bf16 and g.n_spans == 8]
    assert merged and len(old) < len(tc.stitch(spans))


def test_unlogged_calls_keep_the_stream_ordinal_and_the_world():
    """A kernel no logged call launched (a user's own torch.distributed
    call) keeps comm 0: its ordinal counts on its stream, its
    replica_group_size is the world's; a launch within CALL_SLACK_NS of
    a window takes that call's communicator, farther off none."""
    from deepflow_tpu_torch.tpuprobe.comms import CALL_STRIDE, comm_id
    shape, axes = (2, 1, 2), ("data", "fsdp", "tensor")
    spec = kineto_synth.synth_mesh_ranks(shape, axes, n_steps=1)
    bare = _mesh_port_spans(spec, shape, axes, calls=False)[0]
    nccl = [s for s in bare if s.collective]
    assert all(s.program_id < CALL_STRIDE and s.replica_group_size == 4
               for s in nccl)
    # the blocking calls of every communicator count on one stream
    assert [(s.core_id, s.program_id) for s in nccl][:3] == [
        (kineto_synth.STREAM, 1), (kineto_synth.STREAM, 2),
        (kineto_synth.STREAM, 3)]
    # one call: its window moved before its kernel's launch
    op = kineto_synth.SynthOp(kineto_synth.NCCL_ALLREDUCE["BFloat16"],
                              "all-reduce", 2_000_000, 100_000,
                              stream=25, comm="tensor")
    mods = [kineto_synth.SynthModule("jit_train_step(1)", 1000, 0,
                                     3_000_000, [op])]
    trace, hooks = kineto_synth.build_trace({0: mods}, base_ns=BASE_NS)
    (t0, t1, comm), = kineto_synth.call_windows(mods, BASE_NS)
    for shift, logged in ((kineto.CALL_SLACK_NS, True),
                          (kineto.CALL_SLACK_NS + 1, False)):
        got, = [s for s in kineto.extract_device_spans(
            trace, hooks, rank=0, calls=[(t0 - shift - 2, t1 - shift, comm)],
            comm_sizes={comm: 2}, world=4) if s.collective]
        assert got.program_id == (comm * CALL_STRIDE + 1 if logged else 1)
        assert got.replica_group_size == (2 if logged else 4)
