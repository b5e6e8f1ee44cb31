"""The port's dfctl held against the reference's on the CPU: each ported
subcommand, run against a port server, must print what the reference's
dfctl prints against a reference server fed the same frames; an error
answer must end both the same way."""

import json
import os
import subprocess
import sys

import pytest

import test_torch_server as ts
from deepflow_tpu.cli import dfctl as ref_dfctl
from deepflow_tpu_torch.cli import dfctl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_MID = ts.BASE_NS + 15_000_000

COMMANDS = [
    ["query", "SELECT hlo_op, Sum(duration_ns) AS d FROM tpu_hlo_span "
              "GROUP BY hlo_op ORDER BY d DESC", "--db", "profile"],
    ["query", "SELECT run_id, Count() AS n FROM profile.tpu_hlo_span "
              "GROUP BY run_id", "--org", "1"],
    ["query", "SELECT run_id, Count() AS n FROM profile.tpu_hlo_span "
              "GROUP BY run_id", "--org", "2"],
    ["query", "SHOW tags FROM profile.tpu_memory"],
    # a map's values: no row order without ORDER BY
    ["query", "SELECT metric_name, value_name, value FROM deepflow_system "
              "ORDER BY metric_name, value_name", "--db", "deepflow_system"],
    ["flame"],
    ["flame", "--service", "llama-train"],
    ["flame", "--event-type", "off-cpu"],
    ["tpu-flame"],
    ["tpu-flame", "--device", "1"],
    ["tpu-flame", "--include-host"],
    ["tpu-memory"],
    ["tpu-memory", "--device", "0", "--top", "2"],
    ["tpu-memory", "--start", str(T_MID)],
    ["tpu-memory", "--device", "7"],
    ["collectives"],
    ["collectives", "--end", str(T_MID)],
    ["step-trace"],
    ["step-trace", "--run-id", "3"],
    ["step-trace", "--run-id", "99"],
    ["steps"],
    ["steps", "--json"],
    ["steps", "--job", "nope"],
    ["steps", "--run-id", "2", "--limit", "1"],
    ["steps", "--critical-path", "3"],
    ["steps", "--critical-path", "3", "--json"],
]


@pytest.fixture(scope="module")
def pair():
    ref, port = ts._start_pair()
    try:
        frames, counts = ts._frames()
        ts._ingest((ref, port), frames, counts)
        yield ref, port
    finally:
        ref.stop()
        port.stop()


def _run(main, port, args, capsys) -> tuple[str, str]:
    """(stdout, how it ended) of one dfctl run."""
    try:
        rc = main(["--server", f"127.0.0.1:{port}", *args])
        end = f"rc {rc}"
    except SystemExit as e:
        end = f"exit {e.code}"
    return capsys.readouterr().out, end


def _port_transports(api):
    """The reference dfctl's HTTP call with its answers' ici / dcn read
    as the port's nvlink / network."""
    def call(server, path, body=None, token=None):
        out = api(server, path, body, token)
        res = out.get("result") if isinstance(out, dict) else None
        if path == "/v1/profile/TpuCollectives":
            out = dict(out, result=ts.port_transport(res))
        elif path == "/v1/profile/TpuStepTrace":
            out = dict(out, result=dict(
                res, collectives=ts.port_transport(res["collectives"])))
        return out
    return call


@pytest.mark.parametrize("args", COMMANDS, ids=lambda a: " ".join(a)[:60])
def test_subcommand_prints_like_reference(pair, args, capsys, monkeypatch):
    ref, port = pair
    monkeypatch.setattr(ref_dfctl, "_api", _port_transports(ref_dfctl._api))
    want = _run(ref_dfctl.main, ref.query_port, args, capsys)
    got = _run(dfctl.main, port.query_port, args, capsys)
    assert got == want
    assert got[1] == "rc 0" and got[0]


@pytest.mark.parametrize("args", [
    ["query", "SELECT nope FROM profile.tpu_hlo_span"],
    ["query", "SELECT hlo_op FROM"],
    ["steps", "--critical-path", "99"],
], ids=lambda a: " ".join(a)[:60])
def test_errors_end_like_reference(pair, args, capsys):
    ref, port = pair
    assert _run(dfctl.main, port.query_port, args, capsys) == \
        _run(ref_dfctl.main, ref.query_port, args, capsys)


@pytest.mark.parametrize("as_json", [False, True])
def test_health_prints_like_reference(pair, monkeypatch, capsys, as_json):
    """The same /v1/health answer (the port's, with a wedge and an agent
    heartbeat added) prints the same in both: the two servers' own
    health differs in its clocks."""
    _, port = pair
    health = port.api.health()
    health["wedged_stages"] = ["receiver"]
    health["wedges"] = [{"stage": "receiver", "stalled_s": 20.5,
                         "window_s": 15.0, "stack": "  File x\n"}]
    health["agents_selfmon"] = {
        "heartbeats": {"sender": {"stage": "sender", "beats": 4.0,
                                  "progress": 9.0, "age_s": 0.5}},
        "wedges": [{"stage": "sampler", "stalled_s": 30}]}
    for mod in (dfctl, ref_dfctl):
        monkeypatch.setattr(mod, "_api", lambda *a, **k: health)
    args = ["health", *(["--json"] if as_json else [])]
    want = _run(ref_dfctl.main, port.query_port, args, capsys)
    got = _run(dfctl.main, port.query_port, args, capsys)
    assert got == want and got[1] == "rc 0"
    if not as_json:
        assert "server wedge: receiver" in got[0]
        assert "agent wedge: sampler" in got[0]


def test_unreachable_server_exits_like_reference(capsys):
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        closed = s.getsockname()[1]
    got = _run(dfctl.main, closed, ["tpu-flame"], capsys)
    assert got == _run(ref_dfctl.main, closed, ["tpu-flame"], capsys)
    assert got[1].startswith("exit cannot reach")


def test_runs_as_a_module(pair, capsys):
    """python -m deepflow_tpu_torch.cli.dfctl --server H:P tpu-flame prints
    what the in-process call prints, and exits 0."""
    _, port = pair
    out = subprocess.run(
        [sys.executable, "-m", "deepflow_tpu_torch.cli.dfctl", "--server",
         f"127.0.0.1:{port.query_port}", "tpu-flame"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == _run(dfctl.main, port.query_port, ["tpu-flame"],
                              capsys)[0]
    assert "sm90_xmma_gemm" in out.stdout


# -- the flow tables' datasources: promql, trace, trace-search, query-trace,
# datasources

import test_torch_promql as tp  # noqa: E402
import test_torch_tempo as tt  # noqa: E402

S0, S1 = tt.SEARCH_S
FLOW_COMMANDS = [
    ["promql", "sum by (server_port) "
               "(rate(flow_metrics_application_request[1m]))",
     "--time", str(tp.END)],
    ["promql", "histogram_quantile(0.9, sum by (le) "
               "(rate(deepflow_system_req_latency_bucket[1m])))",
     "--start", str(tp.START), "--end", str(tp.END), "--step", "60"],
    ["promql", "scalar(sum(flow_metrics_network_byte_tx))",
     "--time", str(tp.END)],
    ["promql", "sum(flow_metrics_network_byte_tx)", "--time", str(tp.END),
     "--org", "2"],
    ["trace", tt.trace_id(0)],
    ["trace", tt.trace_id(tt.N_TRACES - 1)],
    ["trace-search", "--tags", 'endpoint="/cart"', "--start", str(S0),
     "--end", str(S1)],
    ["trace-search", "--min-duration", "20ms", "--start", str(S0), "--end",
     str(S1), "--limit", "4"],
]


@pytest.fixture(scope="module")
def flow_pair():
    """A reference and a port server holding the same flow rows and L7
    trace frames."""
    from deepflow_tpu_torch.codec import FrameHeader, MessageType, \
        encode_frame
    ref, port = ts._start_pair()
    try:
        net, app, sysrows = tp._rows(0)
        for srv in (ref, port):
            srv.db.table("flow_metrics.network.1s").append_rows(net)
            srv.db.table("flow_metrics.application.1s").append_rows(app)
            srv.db.table("deepflow_system.deepflow_system").append_rows(
                sysrows)
        frames = [encode_frame(FrameHeader(msg_type=MessageType.L7_LOG,
                                           agent_id=agent), payload)
                  for agent, payload, _ in tt._frames(0)]
        ts._ingest((ref, port), frames,
                   {"flow_log.l7_flow_log": 4 * tt.N_TRACES})
        yield ref, port
    finally:
        ref.stop()
        port.stop()


@pytest.mark.parametrize("args", FLOW_COMMANDS,
                         ids=lambda a: " ".join(a)[:60])
def test_flow_subcommand_prints_like_reference(flow_pair, args, capsys):
    ref, port = flow_pair
    want = _run(ref_dfctl.main, ref.query_port, args, capsys)
    got = _run(dfctl.main, port.query_port, args, capsys)
    assert got == want
    assert got[1] == "rc 0" and got[0]


@pytest.mark.parametrize("args", [
    ["promql", "rate(", "--time", "0"],
    ["promql", "flow_metrics_network_byte_tx", "--start", "5"],
    ["trace-search", "--min-duration", "5 parsecs"],
], ids=lambda a: " ".join(a)[:60])
def test_flow_errors_end_like_reference(flow_pair, args, capsys):
    ref, port = flow_pair
    assert _run(dfctl.main, port.query_port, args, capsys) == \
        _run(ref_dfctl.main, ref.query_port, args, capsys)


@pytest.mark.parametrize("flame", [False, True])
def test_query_trace_reads_a_query_just_served(flow_pair, capsys, flame):
    """EXPLAIN ANALYZE on the port's server, then ``query-trace`` of its
    trace id at once (the tracer's pending spans: read-your-writes) shows
    the query's stages, as the reference's does of its own query."""
    import re
    ref, port = flow_pair
    sql = ("EXPLAIN ANALYZE SELECT host, Sum(byte_tx) AS b FROM "
           "flow_metrics.network.1s GROUP BY host")
    names = []
    for main, srv in ((ref_dfctl.main, ref), (dfctl.main, port)):
        tid = srv.api.query({"sql": sql})["explain"]["trace_id"]
        out, end = _run(main, srv.query_port,
                        ["query-trace", tid, *(["--flame"] if flame
                                               else [])], capsys)
        assert end == "rc 0", out
        # the span names, less the timings and the querier's shard name
        names.append(sorted(set(re.findall(r"\b(query|plan|execute|"
                                           r"cache\.lookup|scan\w*)\b",
                                           out))))
    assert names[0] == names[1] and "execute" in names[1]


def test_datasources_lists_tiers_and_horizons(flow_pair, capsys):
    _, port = flow_pair
    port.rollup.roll(tp.T0 + tp.SPAN_S + 4000)
    out, end = _run(dfctl.main, port.query_port, ["datasources"], capsys)
    assert end == "rc 0"
    import re
    assert re.search(r"flow_metrics.application.1m\s+1m\s+\d+", out)
    horizon = (tp.T0 + tp.SPAN_S + 4000 - 90) // 60 * 60
    assert re.search(rf"flow_metrics.network.1m\s+{horizon}\b", out)
    js, _ = _run(dfctl.main, port.query_port, ["datasources", "--json"],
                 capsys)
    assert json.loads(js)["rollup_horizons"][
        "flow_metrics.network.1m"] == horizon
