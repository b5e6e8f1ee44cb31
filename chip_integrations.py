"""The smoke's integrations phase: telemetry in and out on the card's host.

    python3 chip_phases.py integrations     # alone, after phases 1-4
    python3 chip_integrations.py client PORT SEED BASE_NS   # the client

Run by ``chip_smoke.integrations_phase`` after ``enrich``, on one card; it
raises without CUDA. The port's server runs its entry point (with its
combined controller) in a process of its own.

(d, first half) Acked span ingest: the TPU_SPAN frames of phases 2-4,
    REPLAY_PASSES times, go through the agent's durable sender into the
    server, with no exporter attached; the rows over the seconds to the
    last ack print.
(a) Exporters: ``dfctl exporter add`` attaches ``otlp-json`` to an HTTP
    sink, ``remote-write`` to a second, ``kafka`` (the application log,
    Prometheus and ext_metrics tables) to the stub broker of
    ``tests/kafka_stub.py`` and ``json-lines`` of ``event.event`` to a
    third. The same frames again with the four attached, and once more
    with a fifth, a json-lines exporter of the span tables (removed
    after): acked rows/s each way print.
(b) The training job: the node agent captures ``lo`` (flow logs and
    metrics of the phase's own HTTP), and configuration (1) trains
    TRAIN_STEPS steps under ``python -m deepflow_tpu_torch.cli.runner
    -f``, whose config file turns on the agent's integration proxy on a
    free port, in a group whose config ``dfctl agent-group-config`` set
    first (the probe's fallback interval CAPTURE_EVERY_S, so the short
    job is captured). While it trains, a client process posts the seeded corpus
    of ``tests/integration_corpus.py`` (OTLP traces with W3C ids, OTLP
    logs and app logs, remote-write built with the port's ``promwire``,
    Telegraf lines, Datadog msgpack, SkyWalking segments, a folded
    profile) to the proxy on ``localhost``, and this process sends an
    ``EventBatch`` of file-I/O events through the agent's sender.
(c) Gated checks: every ``profile.tpu_step_metrics`` row reaches the
    OTLP sink as exactly one step span with the row's attributes; every
    ``flow_metrics.*.1s`` row reaches the remote-write sink with its
    meters and labels; the Kafka messages and the json-lines lines equal
    the rows of their tables; the rows the integrations wrote
    (``agent_id`` 0) in ``flow_log.l7_flow_log``, ``application_log.log``,
    ``prometheus.samples``, ``ext_metrics.metrics`` and
    ``profile.in_process_profile`` equal exactly what was posted; PromQL
    answers the posted last values of a remote-write series and an
    ``ext_metrics`` series, Tempo a posted trace's spans in its tree,
    DF-SQL the app logs; ``event.file_agg`` holds the windows the events
    imply; for OUTAGE_S the OTLP sink refuses while a trace is posted,
    and every exporter's ``exporter.<kind>`` ledger balances at every
    look, with nothing in flight at the end.
(d, second half) The job's median step (beside the runner phase's),
    each exporter's batches and ship ms.

Every number prints beside the card's name and power limit.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import io
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import chip_smoke as cs

# 40 steps (3.5 s at configuration (1)) end before the probe's first
# capture on the card: it opens once a step ran and a fallback interval
# passed (10 s by default); the job's group config, pushed by dfctl,
# sets that interval to CAPTURE_EVERY_S
TRAIN_STEPS = 60
CAPTURE_EVERY_S = 1.0
JOB_GROUP = "integrations-job"
CORPUS_SEED = 17
NODE_AGENT_ID = 91        # the node agent on lo
EVENT_AGENT_ID = 92       # this process's event sender
REPLAY_AGENT_ID = 93      # the replays' senders: 93, 94, 95
# each replay sends phase 3's span frames this many times: the receiver
# acks a quiet connection on its 0.5 s read tick, which one pass (~56,000
# rows in 14 frames on the card) would mostly measure
REPLAY_PASSES = 8
OUTAGE_S = 3.0            # the OTLP sink refuses this long
OUTAGE_SPANS = 8          # spans posted while it refuses
WAIT_S = 60.0             # each wait's limit
CLIENT_S = 300.0          # the client's limit (it waits for the proxy)
W = 60 * 10**9            # the file-I/O window
EXPORT_TABLES = ("profile.tpu_step_metrics", "flow_metrics.network.1s",
                 "flow_metrics.application.1s", "application_log.log",
                 "prometheus.samples", "ext_metrics.metrics",
                 "event.event", "event.file_agg")
KAFKA_TABLES = ("application_log.log", "prometheus.samples",
                "ext_metrics.metrics")
SPAN_TABLES = ("profile.tpu_hlo_span", "profile.tpu_memory")


def _tests_path() -> None:
    """The stub broker and the corpus are the CPU tests' too."""
    path = os.path.join(cs.ROOT, "tests")
    if path not in sys.path:
        sys.path.insert(0, path)


class Sink:
    """An HTTP destination on a local port keeping each body (gunzipped);
    while ``refuse`` is set it answers 503."""

    def __init__(self) -> None:
        self.bodies: list[bytes] = []
        self.refused = 0
        self.refuse = False
        sink = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a) -> None:
                pass

            def do_POST(self) -> None:  # noqa: N802 (http.server's name)
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if sink.refuse:
                    sink.refused += 1
                    self.send_response(503)
                    self.end_headers()
                    return
                if self.headers.get("Content-Encoding") == "gzip":
                    body = gzip.decompress(body)
                sink.bodies.append(body)
                self.send_response(200)
                self.end_headers()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/v1"
        threading.Thread(target=self.httpd.serve_forever,
                         name="smoke-sink", daemon=True).start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def _wait(cond, what: str, limit_s: float = WAIT_S) -> float:
    t0 = time.perf_counter()
    while not cond():
        cs.check(time.perf_counter() - t0 < limit_s, what)
        time.sleep(0.05)
    return time.perf_counter() - t0


def _sql(qport: int, db: str, sql: str) -> list:
    code, out, _ = cs._http(qport, "/v1/query", {"db": db, "sql": sql})
    cs.check(code == 200, f"DF-SQL {sql!r}: {out}")
    return out["result"]["values"]


def _count(qport: int, db: str, table: str, where: str = "") -> int:
    vals = _sql(qport, db, f"SELECT Count() AS n FROM {table}"
                + (f" WHERE {where}" if where else ""))
    return int(vals[0][0]) if vals else 0


def _dfctl(qport: int, *argv: str) -> str:
    """``dfctl`` as a user runs it, its stdout."""
    from deepflow_tpu_torch.cli import dfctl
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dfctl.main(["--server", f"127.0.0.1:{qport}", *argv])
    return buf.getvalue()


def _exporters(qport: int) -> dict:
    return cs._http(qport, "/v1/exporters")[1]["exporters"]


def _balanced(exps: dict) -> bool:
    return all(st["ledger"]["emitted"] == st["ledger"]["delivered"]
               + st["ledger"]["dropped_total"] + st["ledger"]["in_flight"]
               for st in exps.values())


# -- (d) acked span ingest ----------------------------------------------------

def _span_payloads(frames: list[bytes]) -> list[bytes]:
    return [p for _h, p in cs._span_frames(b"".join(frames))]


def replay(srv, payloads: list[bytes], agent_id: int) -> dict:
    """The span payloads, REPLAY_PASSES times, through the agent's durable
    sender into the server: the span rows over the seconds from the first
    send to the last ack."""
    from deepflow_tpu_torch.agent.sender import UniformSender
    from deepflow_tpu_torch.codec import MessageType

    def rows() -> int:
        t = cs._http(srv.query_port, "/v1/health")[1]["tables"]
        return sum(t[n] for n in SPAN_TABLES)
    before = rows()
    payloads = payloads * REPLAY_PASSES
    sender = UniformSender([("127.0.0.1", srv.ingest_port)],
                           agent_id=agent_id, queue_size=len(payloads) + 8,
                           ack_window=1 << 20).start()
    try:
        last = sender.seq_base + len(payloads)
        t0 = time.perf_counter()
        for p in payloads:
            cs.check(sender.send(MessageType.TPU_SPAN, p),
                     "the sender took every replayed frame")
        _wait(lambda: sender.stats["acked_seq"] >= last,
              "every replayed span frame acked")
        acked_s = time.perf_counter() - t0
    finally:
        sender.flush_and_stop(5.0)
    n = rows() - before
    cs.check(n > 0, "the replay wrote span rows")
    return {"rows": n, "acked_s": acked_s, "rows_per_s": n / acked_s}


# -- (b) the job, the corpus, the events --------------------------------------

def _events(now_ns: int) -> tuple[list, list, dict]:
    """Two EventBatches of file-I/O (and process) events, and the
    windows they imply: (window, pid, path, op) -> [count, bytes, max
    latency, sum latency]. The second batch's event moves the watermark
    past the first two windows; the stop's final flush writes its own."""
    from deepflow_tpu_torch.proto import wire
    w0 = now_ns - now_ns % W - 3 * W
    spec = [(w0 + 1 * 10**9, 10, "/data/shard-0", "read", 4_000_000, 1 << 20),
            (w0 + 2 * 10**9, 10, "/data/shard-0", "read", 9_000_000, 1 << 20),
            (w0 + 3 * 10**9, 10, "/data/shard-0", "read", 1_000_000, 1 << 19),
            (w0 + 4 * 10**9, 11, "/ckpt/step-40", "write", 30_000_000,
             1 << 26),
            (w0 + 5 * 10**9, 11, "/ckpt/step-40", "write", 20_000_000,
             1 << 26),
            (w0 + W + 10**9, 10, "/data/shard-1", "read", 2_000_000, 4096),
            (w0 + W + 2 * 10**9, 10, "/data/shard-1", "read", 3_000_000,
             4096)]
    first = [wire.Event(timestamp_ns=t, event_type=f"file-io-{op}",
                        resource_type="file", resource_name=path, pid=pid,
                        attrs={"latency_ns": str(lat), "bytes": str(b)})
             for t, pid, path, op, lat, b in spec]
    first.append(wire.Event(timestamp_ns=w0 + 6 * 10**9,
                            event_type="process-start",
                            resource_type="process",
                            resource_name="trainer", pid=10,
                            description="rank 0 started"))
    late = (w0 + 3 * W, 12, "/data/shard-2", "read", 5_000, 512)
    second = [wire.Event(timestamp_ns=late[0], event_type="file-io-read",
                         resource_type="file", resource_name=late[2],
                         pid=late[1], attrs={"latency_ns": str(late[4]),
                                             "bytes": str(late[5])})]
    want: dict = {}
    for t, pid, path, op, lat, b in spec + [late]:
        acc = want.setdefault((t - t % W, pid, path, op), [0, 0, 0, 0])
        acc[0] += 1
        acc[1] += b
        acc[2] = max(acc[2], lat)
        acc[3] += lat
    return first, second, want


def send_events(srv, batches: list) -> None:
    from deepflow_tpu_torch.agent.sender import UniformSender
    from deepflow_tpu_torch.codec import MessageType
    from deepflow_tpu_torch.proto import wire
    sender = UniformSender([("127.0.0.1", srv.ingest_port)],
                           agent_id=EVENT_AGENT_ID).start()
    try:
        last = sender.seq_base + len(batches)
        for events in batches:
            sender.send(MessageType.EVENT,
                        wire.EventBatch(events).SerializeToString())
        _wait(lambda: sender.stats["acked_seq"] >= last,
              "the event batches acked")
    finally:
        sender.flush_and_stop(5.0)


class _NodeAgent:
    """``python -m deepflow_tpu_torch.agent --flow --interface lo``: the
    flow logs and metric documents of the phase's own HTTP."""

    def __init__(self, srv) -> None:
        self.log_path = os.path.join(cs.OUT_DIR,
                                     "integrations_node_agent.log")
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "deepflow_tpu_torch.agent", "--server",
             f"127.0.0.1:{srv.ingest_port}", "--flow", "--interface", "lo",
             "--agent-id", str(NODE_AGENT_ID)],
            cwd=cs.ROOT, stdout=self._log, stderr=subprocess.STDOUT)

        def running() -> bool:
            cs.check(self.proc.poll() is None,
                     f"the node agent runs (see {self.log_path})")
            with open(self.log_path) as f:
                return "live-capture" in f.read()
        self.start_s = _wait(running, "the node agent captures lo")

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(15)
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()
        with open(self.log_path) as f:
            text = f.read()
        cs.check(self.proc.returncode == 0 and "Traceback" not in text,
                 f"the node agent stopped cleanly (exit "
                 f"{self.proc.returncode}; see {self.log_path})")


def _runner_yaml(proxy_port: int, qport: int) -> str:
    path = os.path.join(cs.OUT_DIR, "integrations_agent.yaml")
    with open(path, "w") as f:
        f.write("# the training job's agent: its integration proxy\n"
                "integration:\n  enabled: true\n  host: 127.0.0.1\n"
                f"  port: {proxy_port}\n  server_http: 127.0.0.1:{qport}\n")
    return path


def _push_group_config(qport: int) -> str:
    """The job's group config at the controller (``dfctl
    agent-group-config``): a short job's first capture soon after its
    first step. The agent takes it when it registers; a cadence only in
    its own file would give way to the controller's."""
    path = os.path.join(cs.OUT_DIR, "integrations_group.yaml")
    with open(path, "w") as f:
        f.write(f"tpuprobe:\n  trace_interval_s: {CAPTURE_EVERY_S}\n"
                "  steps_per_capture: 5\n")
    out = _dfctl(qport, "agent-group-config", "set", path, "--group",
                 JOB_GROUP)
    cs.check(out.startswith(f"group {JOB_GROUP} -> version"),
             f"dfctl agent-group-config: {out!r}")
    return out.strip()


def client_main(port: int, seed: int, base_ns: int) -> int:
    """The corpus to the proxy at ``localhost:port`` once it listens;
    one JSON line with the answers."""
    _tests_path()
    import integration_corpus as ic
    deadline = time.monotonic() + CLIENT_S
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            break
        except OSError:
            if time.monotonic() > deadline:
                print(json.dumps({"error": "the proxy never listened"}))
                return 1
            time.sleep(0.05)
    t0 = time.perf_counter()
    answers = []
    for path, body, ctype, method, query in ic.corpus(seed,
                                                      base_ns)["posts"]:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}" + (f"?{query}" if query
                                                else ""),
            data=body, method=method, headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                answers.append([path, r.status, json.loads(r.read())])
        except urllib.error.HTTPError as e:
            answers.append([path, e.code, e.read().decode("utf-8",
                                                          "replace")])
    print(json.dumps({"answers": answers,
                      "post_s": time.perf_counter() - t0}), flush=True)
    return 0 if all(a[1] == 200 for a in answers) else 1


# -- (c) the checks over the sinks and the tables -----------------------------

def _step_spans(sink) -> list:
    out = []
    for body in list(sink.bodies):
        for rs in json.loads(body)["resourceSpans"]:
            for ss in rs["scopeSpans"]:
                out += [s for s in ss["spans"]
                        if s["traceId"].startswith("steprun-")]
    return out


def _step_key_of_span(s: dict) -> str:
    attrs = {a["key"]: next(iter(a["value"].values()))
             for a in s["attributes"]}
    return json.dumps([s["traceId"], s["spanId"], s["startTimeUnixNano"],
                       s["endTimeUnixNano"], attrs], sort_keys=True)


def _step_key_of_row(r: dict) -> str:
    """The step span a row must make, built here from the row."""
    rid, step, host = int(r["run_id"]), int(r["step"]), str(r["host"])
    attrs = {"tpu.run_id": rid, "tpu.step": step,
             "tpu.device_count": int(r["device_count"]),
             "tpu.device_skew_ns": int(r["device_skew_ns"]),
             "tpu.collective_ns": int(r["collective_ns"]),
             "tpu.straggler_device": int(r["straggler_device"]),
             "host.name": host}
    return json.dumps([f"steprun-{rid}", f"step-{rid}-{step}-{host}",
                       str(int(r["time"])),
                       str(int(r["end_ns"]) or int(r["time"])), attrs],
                      sort_keys=True)


def _dump_rows(dump: dict, table: str) -> list[dict]:
    cols = dump[table]
    names = list(cols)
    return [dict(zip(names, vals)) for vals in zip(*cols.values())]


_RW = {"flow_metrics.network.1s": (
    "flow_metrics_network_", ("byte_tx", "byte_rx", "packet_tx",
                              "packet_rx", "retrans")),
    "flow_metrics.application.1s": (
    "flow_metrics_application_", ("request", "response", "error_client",
                                  "error_server"))}
_RW_LABELS = ("ip_src", "ip_dst", "server_port", "host", "app_service")


def _series_of_rows(dump: dict) -> collections.Counter:
    out: collections.Counter = collections.Counter()
    for table, (prefix, meters) in _RW.items():
        for r in _dump_rows(dump, table):
            labels = tuple(sorted((k, str(r[k])) for k in _RW_LABELS
                                  if r.get(k) not in (None, "", 0)))
            for m in meters:
                out[(prefix + m, labels, int(r["time"]) * 1000,
                     float(r[m]))] += 1
    return out


def _series_of_sink(sink) -> collections.Counter:
    from deepflow_tpu_torch.server.integration import parse_write_request
    from deepflow_tpu_torch.utils import snappy
    out: collections.Counter = collections.Counter()
    for body in list(sink.bodies):
        for name, labels, samples in parse_write_request(
                snappy.decompress(body)):
            for ts, v in samples:
                out[(name, tuple(sorted(labels.items())), ts, v)] += 1
    return out


def _messages_equal_rows(messages: list[dict], dump: dict,
                         tables: tuple, what: str) -> dict:
    """Each table's messages against its rows in the dump, each row cut
    to the message's keys: equal as multisets."""
    by = collections.defaultdict(list)
    for m in messages:
        m = dict(m)
        by[m.pop("table")].append(m)
    cs.check(set(by) <= set(tables), f"{what}: only its tables "
             f"({sorted(by)})")
    counts = {}
    for table in tables:
        msgs = by.get(table, [])
        rows = _dump_rows(dump, table)
        keys = set().union(*(m.keys() for m in msgs)) if msgs else set()
        got = sorted(json.dumps(m, sort_keys=True) for m in msgs)
        want = sorted(json.dumps({k: r[k] for k in keys}, sort_keys=True)
                      for r in rows)
        cs.check(got == want, f"{what}: the {len(msgs)} messages of "
                 f"{table} equal its {len(rows)} rows")
        counts[table] = len(msgs)
    return counts


# -- the phase ----------------------------------------------------------------

def integrations_phase(span_frames: list[bytes], nums: dict,
                       runner_median_ms: float | None = None) -> None:
    import torch
    cs.check(torch.cuda.is_available(), "CUDA is available")
    import chip_flows
    from deepflow_tpu_torch.store import schema
    _tests_path()
    import integration_corpus as ic
    import kafka_stub
    t_phase = time.perf_counter()
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    cap = chip_flows.capture_support("lo")
    cs.check(cap["af_packet"] == "ok", f"AF_PACKET opens on lo ({cap})")
    payloads = _span_payloads(span_frames)
    cs.check(payloads, "phases 2-4 left span frames to replay")
    dump = {t: [c.name for c in schema.TABLES[t]] for t in EXPORT_TABLES}
    srv = cs._ServerProcess(os.path.join(cs.OUT_DIR,
                                         "integrations_server.log"),
                            dump=dump)
    sinks = {k: Sink() for k in ("otlp", "rw", "events", "spans")}
    broker = kafka_stub.StubBroker(n_partitions=2)
    broker.start()
    node = client = None
    rows = None
    qport = srv.query_port
    try:
        nums["server_start_s"] = srv.start_s
        nums["ingest_none"] = replay(srv, payloads, REPLAY_AGENT_ID)
        specs = [{"type": "otlp-json", "endpoint": sinks["otlp"].url},
                 {"type": "remote-write", "endpoint": sinks["rw"].url},
                 {"type": "kafka", "endpoint":
                  f"kafka://127.0.0.1:{broker.port}/deepflow",
                  "tables": list(KAFKA_TABLES)},
                 {"type": "json-lines", "endpoint": sinks["events"].url,
                  "tables": ["event.event"]}]
        for spec in specs:
            out = _dfctl(qport, "exporter", "add", json.dumps(spec))
            cs.check(out == f"added {spec['type']} -> {spec['endpoint']}\n",
                     f"dfctl exporter add {spec['type']}: {out!r}")
        listed = _dfctl(qport, "exporter", "list")
        cs.check(len(listed.splitlines()) == 4, "dfctl exporter list names "
                 f"the four ({listed!r})")
        nums["ingest_four_attached"] = replay(srv, payloads,
                                              REPLAY_AGENT_ID + 1)
        span_spec = {"type": "json-lines", "endpoint": sinks["spans"].url,
                     "tables": list(SPAN_TABLES)}
        _dfctl(qport, "exporter", "add", json.dumps(span_spec))
        nums["ingest_spans_exported"] = replay(srv, payloads,
                                               REPLAY_AGENT_ID + 2)
        ex = _exporters(qport)
        nums["span_exporter"] = ex[f"JsonLinesExporter:"
                                   f"{sinks['spans'].url}"]
        out = _dfctl(qport, "exporter", "delete", sinks["spans"].url)
        cs.check(out == "removed: 1\n", f"dfctl exporter delete: {out!r}")
        for arm in ("ingest_none", "ingest_four_attached",
                    "ingest_spans_exported"):
            cs.phase(f"integrations {arm}", **nums[arm])

        # (b) the node agent, the job with its proxy, the corpus, events
        node = _NodeAgent(srv)
        nums["node_agent_start_s"] = node.start_s
        proxy_port = cs._closed_port()
        base_ns = (time.time_ns() - 120 * 10**9) // 10**6 * 10**6
        corpus = ic.corpus(CORPUS_SEED, base_ns)
        run: dict = {}
        nums["group_config"] = _push_group_config(qport)
        args = [*cs.RUNNER, "-f", _runner_yaml(proxy_port, qport),
                "--server", f"127.0.0.1:{srv.ingest_port}",
                "--controller", f"127.0.0.1:{srv.sync_port}",
                "--group", JOB_GROUP,
                "--service", "integrations-job", "-m", cs.EXAMPLE,
                *cs.EXAMPLE_ARGS, "--steps", str(TRAIN_STEPS)]

        def train() -> None:
            try:
                run.update(cs._train_child(args, "integrations_train"))
            except Exception as e:   # noqa: BLE001 (read below)
                run["error"] = e
        trainer = threading.Thread(target=train, name="integrations-train",
                                   daemon=True)
        trainer.start()
        client = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "client",
             str(proxy_port), str(CORPUS_SEED), str(base_ns)],
            cwd=cs.ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        first, second, want_windows = _events(time.time_ns())
        send_events(srv, [first, second])
        out, err = client.communicate(timeout=CLIENT_S)
        cs.check(client.returncode == 0, f"the corpus client: {out} {err}")
        posted = json.loads(out.strip().splitlines()[-1])
        nums["corpus_post_s"] = posted["post_s"]
        trainer.join(cs.RUNNER_CHILD_S)
        cs.check("error" not in run and run.get("steps") == TRAIN_STEPS,
                 f"the job trained {TRAIN_STEPS} steps ({run.get('error')})")
        nums.update(job_step_ms_median=run["step_ms_median"],
                    job_step_ms_mean=run["step_ms_mean"],
                    runner_phase_step_ms_median=runner_median_ms,
                    job_wall_s=run["wall_s"])

        # every step row of the job reaches the OTLP sink before the outage
        cs._ingest_settled(qport)
        steps_n = _count(qport, "profile", "tpu_step_metrics")
        cs.check(steps_n > 0, "the job's step rows")
        _wait(lambda: len(_step_spans(sinks["otlp"])) >= steps_n,
              f"the {steps_n} step spans reach the OTLP sink")

        # the outage: the OTLP sink refuses while a trace is posted
        sinks["otlp"].refuse = True
        outage = ic.corpus(CORPUS_SEED + 1, base_ns, traces=2)["posts"][0]
        code, ans, _ = cs._http(qport, outage[0], json.loads(outage[1]))
        cs.check(code == 200 and ans["accepted_spans"] == OUTAGE_SPANS,
                 f"the outage's trace posted ({ans})")
        looks = 0
        t_out = time.perf_counter()
        while time.perf_counter() - t_out < OUTAGE_S:
            cs.check(_balanced(_exporters(qport)),
                     "every exporter's ledger balances in the outage")
            looks += 1
            time.sleep(0.1)
        sinks["otlp"].refuse = False
        node.stop()
        node = None
        health = cs._ingest_settled(qport)

        def drained() -> bool:
            ex = _exporters(qport)
            cs.check(_balanced(ex), "every exporter's ledger balances")
            return all(st["ledger"]["in_flight"] == 0 for st in ex.values())
        _wait(drained, "every exporter ships what it took")
        ex = _exporters(qport)
        otlp = ex[f"OtlpJsonExporter:{sinks['otlp'].url}"]
        cs.check(otlp["ledger"]["dropped_total"] > 0
                 and sinks["otlp"].refused > 0,
                 "the outage's batches are counted dropped "
                 f"({otlp['ledger']})")
        nums["outage"] = {"looks": looks, "refused": sinks["otlp"].refused,
                          "ledger": otlp["ledger"]}

        # exact counts of what the integrations wrote (agent_id 0)
        want = dict(corpus["counts"])
        want["flow_log.l7_flow_log"] += OUTAGE_SPANS
        got = {t: _count(qport, *t.split("."), "agent_id = 0")
               for t in want}
        cs.check(got == want, f"the posted rows, exactly ({got} != {want})")
        nums["rows_posted"] = got
        cs.check(health["tables"]["event.event"] == len(first) + len(second),
                 "every event row")

        # the readers
        base_s = base_ns // 10**9
        for key in ("remote_write", "telegraf"):
            name, labels, value = corpus[key]
            sel = ",".join(f'{k}="{v}"' for k, v in labels.items())
            q = urllib.parse.urlencode({"query": f"{name}{{{sel}}}",
                                        "time": base_s + 20})
            code, ans, ms = cs._http(qport, f"/api/v1/query?{q}")
            res = ans.get("data", {}).get("result", [])
            cs.check(code == 200 and len(res) == 1 and math.isclose(
                float(res[0]["value"][1]), value, rel_tol=1e-12),
                f"PromQL answers {name}'s posted value {value} ({ans})")
            nums[f"promql_{key}_ms"] = ms
        code, tr, nums["tempo_ms"] = cs._http(
            qport, f"/api/traces/{corpus['trace_id']}")
        spans = [s for b in tr.get("batches", []) for s in b["spans"]]
        cs.check(code == 200 and len(spans) == corpus["trace_spans"]
                 and [s["parentSpanID"] for s in spans][1:]
                 == [s["spanID"] for s in spans][:-1],
                 f"Tempo answers the posted trace as its tree ({tr})")
        logs = _sql(qport, "application_log",
                    "SELECT body FROM log WHERE body = 'app line 3'")
        cs.check(logs == [["app line 3"]], f"DF-SQL reads the app logs "
                 f"({logs})")

        nums["exporters"] = {
            name.split(":")[0]: {"batches": st["batches"],
                                 "exported": st["exported"],
                                 "errors": st["errors"],
                                 "dropped": st["dropped"],
                                 "ship_ms": st["ship_ns"] / 1e6}
            for name, st in ex.items()}
        cs.check(len(nums["exporters"]) == 4, "the four exporters remain")
        rows = srv.stop()
    finally:
        if client is not None and client.poll() is None:
            client.kill()
            client.wait()
        if node is not None and node.proc.poll() is None:
            node.proc.kill()
            node.proc.wait()
        srv.stop()
        broker.stop()
        for s in sinks.values():
            s.stop()

    # the sinks against the tables the server handed over
    step_rows = [_step_key_of_row(r)
                 for r in _dump_rows(rows, "profile.tpu_step_metrics")]
    step_spans = [_step_key_of_span(s) for s in _step_spans(sinks["otlp"])]
    cs.check(sorted(step_spans) == sorted(step_rows),
             f"every step row is one step span ({len(step_spans)} spans, "
             f"{len(step_rows)} rows)")
    want_series = _series_of_rows(rows)
    got_series = _series_of_sink(sinks["rw"])
    cs.check(sum(want_series.values()) > 0, "flow_metrics rows were written")
    cs.check(got_series == want_series,
             f"every flow_metrics row reached the remote-write sink "
             f"({sum(got_series.values())} samples, "
             f"{sum(want_series.values())} from the rows)")
    kafka = [json.loads(v) for vs in broker.messages.values() for v in vs]
    cs.check(broker.crc_failures == 0, "every Kafka message's CRC")
    nums["kafka_messages"] = _messages_equal_rows(
        kafka, rows, KAFKA_TABLES, "Kafka")
    lines = [json.loads(ln) for b in sinks["events"].bodies
             for ln in b.splitlines()]
    nums["json_lines"] = _messages_equal_rows(
        lines, rows, ("event.event",), "json-lines")
    got_windows = {}
    for r in _dump_rows(rows, "event.file_agg"):
        op = ("read", "write")[int(r["op"])]
        key = (int(r["time"]), int(r["pid"]), r["path"], op)
        cs.check(key not in got_windows, f"one row a window ({key})")
        got_windows[key] = [int(r["count"]), int(r["bytes"]),
                            int(r["max_latency_ns"]),
                            int(r["sum_latency_ns"])]
    cs.check(got_windows == want_windows,
             f"event.file_agg holds the events' windows ({got_windows})")
    nums.update(step_spans=len(step_spans),
                remote_write_samples=sum(got_series.values()),
                file_agg_windows=len(got_windows))
    nums["phase_s"] = time.perf_counter() - t_phase
    cs.phase("integrations", phase_s=nums["phase_s"],
             job_step_ms_median=nums["job_step_ms_median"],
             runner_phase_step_ms_median=runner_median_ms,
             step_spans=nums["step_spans"],
             remote_write_samples=nums["remote_write_samples"],
             kafka_messages=sum(nums["kafka_messages"].values()),
             rows_per_s_none=nums["ingest_none"]["rows_per_s"],
             rows_per_s_four=nums["ingest_four_attached"]["rows_per_s"],
             rows_per_s_spans=nums["ingest_spans_exported"]["rows_per_s"])
    for name, st in nums["exporters"].items():
        cs.phase(f"integrations exporter {name}", **st)


if __name__ == "__main__":
    if sys.argv[1:2] == ["client"]:
        sys.exit(client_main(int(sys.argv[2]), int(sys.argv[3]),
                             int(sys.argv[4])))
    print("run through chip_smoke.py or chip_phases.py integrations",
          file=sys.stderr)
    sys.exit(2)
