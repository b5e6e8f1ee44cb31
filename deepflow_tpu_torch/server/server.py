"""The port's server: receiver + decoders + store + querier in one process.

Own copy of the profile path of ``deepflow_tpu/server/server.py::Server``:
TPU_SPAN and STEP_METRICS frames arrive over TCP, decode into the
profile tables, and the querier answers the profile queries over HTTP.
The server touches no device.

    python -m deepflow_tpu_torch.server [--host H] [--ingest-port P]
                                        [--query-port Q]

Once it listens it prints one JSON line with the bound ports, so that a
parent process that asked for port 0 can find them. SIGTERM or SIGINT
stops it after the decoders have drained their queues.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading
import time

from deepflow_tpu_torch.codec import MessageType
from deepflow_tpu_torch.server.decoders import (
    StepMetricsDecoder, TpuSpanDecoder)
from deepflow_tpu_torch.server.platform_info import PlatformInfoTable
from deepflow_tpu_torch.server.querier import QuerierAPI, QuerierHTTP
from deepflow_tpu_torch.server.receiver import Receiver
from deepflow_tpu_torch.store.db import Database

log = logging.getLogger("df.server")


class Server:
    def __init__(self, host: str = "127.0.0.1", ingest_port: int = 20033,
                 query_port: int = 20416) -> None:
        self.db = Database()
        self.platform = PlatformInfoTable()
        self.receiver = Receiver(host=host, port=ingest_port)
        self.decoders = []
        self.api = QuerierAPI(self.db, stats_provider=self._stats)
        self.http = QuerierHTTP(self.api, host=host, port=query_port)

    def _stats(self) -> dict:
        return {
            "receiver": dict(self.receiver.stats),
            "decoders": {d.MSG_TYPE.name: dict(d.stats)
                         for d in self.decoders},
        }

    def start(self) -> "Server":
        # register every queue before listening: no frame finds none
        for cls in (TpuSpanDecoder, StepMetricsDecoder):
            q = self.receiver.register(cls.MSG_TYPE)
            self.decoders.append(cls(q, self.db, self.platform).start())
        self.receiver.start()
        self.http.start()
        log.info("server up: ingest :%d query :%d", self.ingest_port,
                 self.query_port)
        return self

    def stop(self) -> None:
        # the receiver first: once its handlers are gone nothing enqueues,
        # and each decoder's stop drains what is queued
        self.receiver.stop()
        for d in self.decoders:
            d.stop()
        self.http.stop()

    @property
    def ingest_port(self) -> int:
        return self.receiver.port

    @property
    def query_port(self) -> int:
        return self.http.port

    def wait_for_rows(self, table: str, n: int, timeout: float = 5.0) -> bool:
        """Block until a table holds >= n rows, or the timeout passes."""
        deadline = time.monotonic() + timeout
        t = self.db.table(table)
        while time.monotonic() < deadline:
            if len(t) >= n:
                return True
            time.sleep(0.02)
        return len(t) >= n


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="deepflow-tpu profile server (PyTorch port)")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address of both listeners (0.0.0.0 to "
                             "take frames from other hosts)")
    parser.add_argument("--ingest-port", type=int, default=20033)
    parser.add_argument("--query-port", type=int, default=20416)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    server = Server(host=args.host, ingest_port=args.ingest_port,
                    query_port=args.query_port).start()
    try:
        print(json.dumps({"ingest_port": server.ingest_port,
                          "query_port": server.query_port}), flush=True)
        stop.wait()
    finally:
        server.stop()
