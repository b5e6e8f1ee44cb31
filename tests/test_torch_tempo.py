"""The port's Tempo datasource and trace tree held against the JAX
package on the CPU.

Four agents, each a tier of one HTTP service (frontend, cart, checkout,
db), ship the L7 rows of the same traces, made from a numpy seed: every
request carries a W3C trace id and its span's parent is the tier
before. The same frames go through the reference's ``FlowLogDecoder``
and the port's, each feeding its ``TraceTreeBuilder``; most traces are
flushed to ``flow_log.trace_tree``, a few stay pending. Then the rows of
``flow_log.trace_tree``, and the answers of ``tempo_trace``,
``tempo_search`` (tags, durations, limits), the tag lists,
``trace_search`` (service paths, root service, durations), ``trace``
(by trace id and by syscall chain) must be equal in both packages, also
with a Jaeger backend served by a local stub spliced into the trace.
"""

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from deepflow_tpu.codec import FrameHeader as RefHeader
from deepflow_tpu.server import decoders as ref_decoders
from deepflow_tpu.server.platform_info import AgentInfo as RefAgentInfo
from deepflow_tpu.server.platform_info import PlatformInfoTable as RefPlatform
from deepflow_tpu.server.querier import QuerierAPI as RefQuerierAPI
from deepflow_tpu.server.tracetree import TraceTreeBuilder as RefTrees
from deepflow_tpu.store.db import Database as RefDatabase
from deepflow_tpu_torch.codec import FrameHeader, MessageType
from deepflow_tpu_torch.proto import wire
from deepflow_tpu_torch.server.decoders import FlowLogDecoder
from deepflow_tpu_torch.server.platform_info import AgentInfo
from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
from deepflow_tpu_torch.server.querier import QuerierAPI
from deepflow_tpu_torch.server.tracetree import TraceTreeBuilder
from deepflow_tpu_torch.store.db import Database
from test_torch_retention import _table_rows

T0 = 1_760_000_000_000_000_000
TIERS = ("frontend", "cart", "checkout", "db")
N_TRACES = 30
PENDING = 4  # the last traces stay in the builders, unflushed


def trace_id(i: int) -> str:
    return f"{i + 1:032x}"


def _frames(seed: int) -> list[tuple[int, bytes, bool]]:
    """(agent id, L7_LOG payload, flushed) per tier and trace group:
    trace i's span k is tier k's, a child of span k - 1, inside it."""
    rng = np.random.default_rng(seed)
    per: dict[tuple[int, bool], list] = {}
    for i in range(N_TRACES):
        t = T0 + i * 10**9 + int(rng.integers(0, 10**6))
        dur = int(rng.integers(4, 40)) * 10**6
        for k in range(4):
            f = wire.L7FlowLog(
                flow_id=1000 * i + k, l7_protocol=wire.HTTP1,
                version="1.1", request_type="GET",
                request_domain=f"{TIERS[k]}.svc",
                request_resource=f"/{TIERS[k]}/{i % 3}",
                endpoint=f"/{TIERS[k]}",
                request_id=k + 1,
                response_status=(wire.SERVER_ERROR if i % 7 == 3 and k == 3
                                 else wire.OK),
                response_code=500 if i % 7 == 3 and k == 3 else 200,
                start_time_ns=t + k * 10**6,
                end_time_ns=t + dur - k * 10**6,
                trace_id=trace_id(i), span_id=f"{i:08x}{k:08x}",
                parent_span_id=f"{i:08x}{k - 1:08x}" if k else "",
                syscall_trace_id_request=7000 + i,
                syscall_trace_id_response=7000 + i if k < 3 else 0)
            f.key.ip_src = bytes([10, 0, k, 1])
            f.key.ip_dst = bytes([10, 0, k + 1, 1])
            f.key.port_src = 40000 + i
            f.key.port_dst = 8080
            f.key.proto = wire.TCP
            per.setdefault((k + 1, i < N_TRACES - PENDING), []).append(f)
    return [(agent, wire.FlowLogBatch(l7=rows).SerializeToString(), flushed)
            for (agent, flushed), rows in sorted(per.items(),
                                                 key=lambda kv: -kv[0][1])]


class _Jaeger(BaseHTTPRequestHandler):
    """A Jaeger query service holding one app span under trace 0's root."""

    def log_message(self, *a):
        pass

    def do_GET(self):
        tid = self.path.rsplit("/", 1)[-1]
        spans = [] if tid != trace_id(0) else [{
            "spanID": "app-1", "operationName": "render cart",
            "processID": "p1", "startTime": (T0 + 2 * 10**6) // 1000,
            "duration": 1500,
            "references": [{"refType": "CHILD_OF",
                            "spanID": f"{0:08x}{1:08x}"}]}]
        body = json.dumps({"data": [{"traceID": tid, "spans": spans,
                                     "processes": {"p1": {
                                         "serviceName": "cart-app"}}}]})
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(body.encode())


@pytest.fixture(scope="module")
def apis():
    ref_db, db = RefDatabase(), Database()
    ref_trees, trees = RefTrees(ref_db), TraceTreeBuilder(db)
    ref_plat, plat = RefPlatform(), PlatformInfoTable()
    for k, host in enumerate(TIERS):
        ref_plat.update(RefAgentInfo(agent_id=k + 1, host=host))
        plat.update(AgentInfo(agent_id=k + 1, host=host))
    ref_dec = ref_decoders.FlowLogDecoder(queue.Queue(), ref_db, ref_plat,
                                          trace_trees=ref_trees)
    dec = FlowLogDecoder(queue.Queue(), db, plat, trace_trees=trees)
    flushed = False
    for agent, payload, done in _frames(0):
        if not done and not flushed:  # the flushed traces are complete
            assert ref_trees.flush_all() == trees.flush_all() > 0
            flushed = True
        ref_dec.handle(RefHeader(msg_type=MessageType.L7_LOG,
                                 agent_id=agent), payload)
        dec.handle(FrameHeader(msg_type=MessageType.L7_LOG,
                               agent_id=agent), payload)
    assert dec.stats["native_batches"] == 8
    stub = ThreadingHTTPServer(("127.0.0.1", 0), _Jaeger)
    threading.Thread(target=stub.serve_forever, daemon=True).start()
    yield (RefQuerierAPI(ref_db, trace_trees=ref_trees),
           QuerierAPI(db, trace_trees=trees),
           f"http://127.0.0.1:{stub.server_address[1]}")
    stub.shutdown()
    stub.server_close()


def test_trace_tree_rows_equal_reference(apis):
    ref, port, _ = apis
    got = _table_rows(port.db.table("flow_log.trace_tree"))
    assert got == _table_rows(ref.db.table("flow_log.trace_tree"))
    assert len(got) == N_TRACES - PENDING
    row = dict(zip(port.db.table("flow_log.trace_tree").columns, got[0]))
    assert json.loads(row["services"]) == list(TIERS)
    assert row["span_count"] == 4 and row["root_service"] == "frontend"
    assert ref.trace_trees.pending_summaries() == \
        port.trace_trees.pending_summaries()


@pytest.mark.parametrize("i", [0, 3, N_TRACES - PENDING - 1, N_TRACES - 1])
def test_tempo_trace_equals_reference(apis, i):
    """Flushed and pending traces: 4 spans, each the child of the one
    before, in Tempo's shape."""
    ref, port, _ = apis
    got = port.tempo_trace(trace_id(i))
    assert got == ref.tempo_trace(trace_id(i))
    spans = got["batches"][0]["spans"]
    assert [s["serviceName"] for s in spans] == list(TIERS)
    assert [s["parentSpanID"] for s in spans] == \
        [""] + [s["spanID"] for s in spans[:-1]]


SEARCH_S = (T0 // 10**9, T0 // 10**9 + N_TRACES + 1)
SEARCHES = [
    {},
    {"tags": 'endpoint="/cart"'},
    {"tags": "http.status_code=500"},
    {"tags": "endpoint=/db http.status_code=200", "limit": "5"},
    {"minDuration": "20ms"},
    {"maxDuration": "15ms", "limit": "3"},
    {"tags": "l7.protocol=http1"},
]


@pytest.mark.parametrize("params", SEARCHES, ids=str)
def test_tempo_search_equals_reference(apis, params):
    ref, port, _ = apis
    q = {"start": str(SEARCH_S[0]), "end": str(SEARCH_S[1]), **params}
    got = port.tempo_search(q)
    assert got == ref.tempo_search(q)
    assert got["traces"]


def test_tempo_search_tags_and_values_equal_reference(apis):
    ref, port, _ = apis
    assert port.tempo_search_tags() == ref.tempo_search_tags()
    for name in ("service.name", "endpoint", "l7.protocol",
                 "http.status_code", "nope"):
        assert port.tempo_search_tag_values(name) == \
            ref.tempo_search_tag_values(name)


@pytest.mark.parametrize("body", [
    {}, {"service_path": ["cart", "checkout"]}, {"service_path": "db"},
    {"service_path": "frontend>checkout"}, {"root_service": "frontend"},
    {"min_duration_ns": 20 * 10**6, "limit": 4},
    {"from_ns": T0 + 5 * 10**9, "to_ns": T0 + 9 * 10**9},
], ids=str)
def test_trace_search_equals_reference(apis, body):
    ref, port, _ = apis
    got = port.trace_search(body)
    assert got == ref.trace_search(body)
    if body.get("service_path") != "frontend>checkout":
        assert got["result"]["count"] > 0


@pytest.mark.parametrize("body", [
    {"trace_id": trace_id(2)}, {"trace_id": "absent"},
    {"syscall_trace_id": 7005}], ids=str)
def test_trace_equals_reference(apis, body):
    ref, port, _ = apis
    assert port.trace(body) == ref.trace(body)


def test_jaeger_adapter_splices_into_the_trace_as_reference(apis):
    ref, port, url = apis
    try:
        for api in (ref, port):
            assert api.tracing_adapters_api({"kind": "jaeger",
                                             "base_url": url}) == \
                {"adapters": [{"kind": "jaeger", "base_url": url}]}
        got = port.trace({"trace_id": trace_id(0)})
        assert got == ref.trace({"trace_id": trace_id(0)})
        cart = got["result"]["spans"][0]["children"][0]
        assert sorted(c["service"] for c in cart["children"]) == \
            ["cart-app", "checkout"]
    finally:
        for api in (ref, port):
            api.tracing_adapters_api({"remove": url})
