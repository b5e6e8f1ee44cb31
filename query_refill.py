#!/usr/bin/env python3
"""The query cache's bucket refill, serially and on the scan pool.

    python3 query_refill.py [--flows 20000] [--span-rows 3000000 10000000]

Runs on the CPU, in process. Two workloads, each query cold (a new cache
key) and timed three times with the refill forced each way:

- the `flows` phase's rollup traffic (chip_flows.py: the dispatcher's
  metric documents at --flows flows, re-stamped over three hours of 1 s
  buckets) in the port's server, rolled once: chip_flows.rollup_part's
  two-hour query on the 1m tier and on the 1 s table;
- a span table of each --span-rows rows over 39 minutes (300 kernel
  names, 1,015 kernels a step): the `query` phase's time-per-step query.

Prints one JSON object a line: workload, table rows, buckets, refill
way and the three times in ms.
"""

from __future__ import annotations

import argparse
import json
import socket
import time

import numpy as np

import chip_flows as cf
from deepflow_tpu_torch.query.cache import QueryCache
from deepflow_tpu_torch.query.costmodel import KernelCostModel

WAYS = ("serial", "pool")


def _forced(cache: QueryCache, table: str, way: str) -> None:
    model = KernelCostModel(kernels=WAYS)
    model.choose = lambda n: way
    cache._refill[table] = model


def _report(workload: str, table, way: str, ms: list[float]) -> None:
    print(json.dumps({"workload": workload, "rows": len(table),
                      "buckets": len(table.bucket_marks()[1]),
                      "refill": way, "ms": ms}), flush=True)


def rollup_traffic(flows: int) -> None:
    from deepflow_tpu_torch.agent.dispatcher import Dispatcher
    from deepflow_tpu_torch.codec import FrameHeader, MessageType, \
        encode_frame
    from deepflow_tpu_torch.server.server import Server
    data, offsets, ts, _n = cf.bench_frames(flows, net=11, http=True)
    sink = cf._Frames()
    disp = Dispatcher(sender=sink)
    with disp._lock:
        disp.native_map.inject_batch(data, offsets, ts)
    disp.flush(now_ns=int(ts[-1]) + 1)
    disp.flush(force=True)
    payloads, lo_s, hi_s, rows = cf._restamped(sink.frames)
    srv = Server(ingest_port=0, query_port=0).start()
    try:
        with socket.create_connection(("127.0.0.1", srv.ingest_port)) as c:
            for p in payloads:
                c.sendall(encode_frame(FrameHeader(
                    MessageType.METRICS, agent_id=2), p))
        for fam, n in rows.items():
            assert srv.wait_for_rows(f"flow_metrics.{fam}.1s", n, 120)
        srv.rollup.roll(now_s=int(time.time()))
        sql = ("SELECT server_port, Sum(byte_tx) AS b, Sum(new_flow) AS f, "
               "Sum(packet_tx) AS p FROM network WHERE time >= {lo} AND "
               "time {op} {hi} GROUP BY server_port ORDER BY server_port")
        for tier, op, cut in (("1m", "<", 0), ("1s", "<=", 1)):
            table = srv.db.table(f"flow_metrics.network.{tier}")
            for way in WAYS:
                ms = []
                for i in range(3):  # a new window each time: cold
                    lo = lo_s + 420 + 60 * i + (600 if way == "pool" else 0)
                    _forced(srv.api.query_cache, table.name, way)
                    t0 = time.perf_counter()
                    ans = srv.api.query({"db": "flow_metrics",
                                         "sql": sql.format(
                                             lo=lo, op=op,
                                             hi=lo + 7200 - cut)})
                    ms.append((time.perf_counter() - t0) * 1e3)
                    assert ans["debug"]["table"] == table.name, ans["debug"]
                _report(f"rollup {tier}", table, way, ms)
    finally:
        srv.stop()


def span_table(n: int) -> None:
    from deepflow_tpu_torch.store import schema
    from deepflow_tpu_torch.store.table import ColumnarTable
    name = "profile.tpu_hlo_span"
    table = ColumnarTable(name, schema.TABLES[name])
    rng = np.random.default_rng(0)
    base, per_ns = 1_760_000_000_000_000_000, 39 * 60 * 10**9 // n
    for lo in range(0, n, 500_000):
        m = min(500_000, n - lo)
        i = np.arange(lo, lo + m, dtype=np.uint64)
        table.append_columns({
            "time": base + i * np.uint64(per_ns),
            "hlo_op": [f"op{k}" for k in rng.integers(0, 300, m)],
            "duration_ns": rng.integers(0, 10**6, m).astype(np.uint64),
            "run_id": (i // np.uint64(1015)).astype(np.uint64)}, m)
    for way in WAYS:
        ms = []
        for i in range(3):
            cache = QueryCache()
            _forced(cache, name, way)
            sql = ("SELECT run_id, Sum(duration_ns) AS d, Count() AS n "
                   f"FROM t WHERE duration_ns >= {i} GROUP BY run_id")
            t0 = time.perf_counter()
            cache.execute(table, sql)
            ms.append((time.perf_counter() - t0) * 1e3)
        _report("span per_step", table, way, ms)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--flows", type=int, default=cf.FLOWS)
    ap.add_argument("--span-rows", type=int, nargs="*",
                    default=[3_000_000, 10_000_000])
    args = ap.parse_args()
    rollup_traffic(args.flows)
    for n in args.span_rows:
        span_table(n)


if __name__ == "__main__":
    main()
