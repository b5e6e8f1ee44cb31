"""Remote shard execution: POST /v1/shard/exec with timeout/retry/hedge.

Own copy of ``deepflow_tpu/cluster/remote.py``; its hop ledgers are the
port's ``telemetry.py`` ones, its trace spans the port's
``query/qtrace.py`` ones.

Each logical shard call is one HopLedger item on its fan-out hop:
emitted when the scatter starts, delivered on any successful response,
dropped (reason timeout|error) when every attempt fails — so
``emitted == delivered + dropped`` holds across a quiesced cluster and
a check can assert ledger balance over federated queries.
Retries and the hedged second request are attempts WITHIN one item,
tracked in client stats only. Each calling thread keeps one HTTP/1.1
connection a peer open (the reference opens one a call): with the
querier's keep-alive a warm federated query costs a peer no connect and
no thread.
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

from deepflow_tpu_torch.cluster import wire
from deepflow_tpu_torch.cluster.membership import Peer

log = logging.getLogger("df.cluster")


class ShardCallError(Exception):
    def __init__(self, msg: str, reason: str = "error") -> None:
        super().__init__(msg)
        self.reason = reason  # "timeout" | "error"


class ShardClient:
    """One peer's /v1/shard/exec client."""

    def __init__(self, addr: str, timeout_s: float = 5.0,
                 retries: int = 1, hedge_delay_s: float = 0.25,
                 api_token: str | None = None) -> None:
        self.addr = addr
        self.timeout_s = timeout_s
        self.retries = retries            # extra attempts after the first
        self.hedge_delay_s = hedge_delay_s
        self.api_token = api_token
        self.stats = {"attempts": 0, "hedges": 0, "errors": 0}
        self._lock = threading.Lock()
        # one kept-alive connection a calling thread (the fan-out's
        # attempt workers): a call costs no connect and no server thread
        self._local = threading.local()

    def _conn(self, budget: float) -> tuple[http.client.HTTPConnection, bool]:
        """(this thread's connection to the peer, whether its socket is
        already open)."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.timeout = budget
            if conn.sock is not None:
                conn.sock.settimeout(budget)
                return conn, True
            return conn, False
        host, _, port = self.addr.rpartition(":")
        conn = self._local.conn = http.client.HTTPConnection(
            host, int(port), timeout=budget)
        return conn, False

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        self._local.conn = None
        if conn is not None:
            conn.close()

    def _attempt(self, body: dict, deadline: float):
        budget = deadline - time.monotonic()
        if budget <= 0:
            raise ShardCallError(f"{self.addr}: deadline exhausted",
                                 reason="timeout")
        with self._lock:
            self.stats["attempts"] += 1
        headers = {"Content-Type": "application/json"}
        if self.api_token:
            headers["X-DF-Token"] = self.api_token
        payload = json.dumps(body).encode()
        while True:
            conn, reused = self._conn(budget)
            try:
                conn.request("POST", "/v1/shard/exec", payload, headers)
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.HTTPException, TimeoutError, OSError) as e:
                self._drop_conn()
                if reused and not isinstance(e, TimeoutError):
                    # the peer closed a kept-alive connection (a restart,
                    # its stop): one more try on a fresh one
                    continue
                reason = ("timeout" if isinstance(e, TimeoutError)
                          or "timed out" in str(e).lower() else "error")
                raise ShardCallError(f"{self.addr}: {e}", reason=reason) \
                    from None
            break
        if resp.status != 200:
            self._drop_conn()
            detail = data[:200].decode(errors="replace")
            raise ShardCallError(f"{self.addr}: HTTP {resp.status} {detail}")
        obj, _sid = wire.decode_result(data)
        return obj

    def call(self, body: dict, pool: ThreadPoolExecutor | None = None):
        """One logical call: bounded retries, plus a hedged second
        attempt racing the first once hedge_delay_s passes without an
        answer (slow-shard tail cut, reference: hedged ClickHouse
        connections in the querier)."""
        deadline = time.monotonic() + self.timeout_s
        last: ShardCallError | None = None
        for _ in range(1 + max(0, self.retries)):
            if pool is None or self.hedge_delay_s <= 0:
                try:
                    return self._attempt(body, deadline)
                except ShardCallError as e:
                    last = e
                    continue
            primary = pool.submit(self._attempt, body, deadline)
            done, _ = wait([primary], timeout=self.hedge_delay_s)
            futures = [primary]
            if not done:
                with self._lock:
                    self.stats["hedges"] += 1
                futures.append(pool.submit(self._attempt, body, deadline))
            pending = set(futures)
            while pending:
                done, pending = wait(
                    pending, timeout=max(0.0, deadline - time.monotonic()),
                    return_when=FIRST_COMPLETED)
                if not done:   # overall deadline hit; attempts self-expire
                    break
                for f in done:
                    try:
                        result = f.result()
                    except ShardCallError as e:
                        last = e
                        continue
                    for p in pending:
                        p.cancel()
                    return result
            if last is None:
                last = ShardCallError(f"{self.addr}: deadline exhausted",
                                      reason="timeout")
        with self._lock:
            self.stats["errors"] += 1
        raise last


class FanOut:
    """Scatter one op over the alive remote peers, gather with a
    missing_shards annotation instead of an error (degraded mode)."""

    def __init__(self, telemetry=None, timeout_s: float = 5.0,
                 retries: int = 1, hedge_delay_s: float = 0.25,
                 api_token: str | None = None,
                 max_workers: int = 16) -> None:
        self.telemetry = telemetry
        self.timeout_s = timeout_s
        self.retries = retries
        self.hedge_delay_s = hedge_delay_s
        self.api_token = api_token
        self._clients: dict[str, ShardClient] = {}
        self._last_used: dict[str, float] = {}
        self.evicted = 0
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="df-fanout")
        # attempts run in their own pool: if per-shard calls and their
        # retry/hedge attempts shared one saturated pool, the outer
        # futures would starve the inner ones into a deadline stall
        self._attempt_pool = ThreadPoolExecutor(
            max_workers=2 * max_workers, thread_name_prefix="df-fanout-io")

    def client(self, addr: str) -> ShardClient:
        with self._lock:
            c = self._clients.get(addr)
            if c is None:
                c = self._clients[addr] = ShardClient(
                    addr, timeout_s=self.timeout_s, retries=self.retries,
                    hedge_delay_s=self.hedge_delay_s,
                    api_token=self.api_token)
            self._last_used[addr] = time.monotonic()
            return c

    def prune(self, active_addrs: set[str] | list[str],
              ttl_s: float = 300.0) -> int:
        """Evict clients whose peer left the directory, or that no
        scatter touched for ttl_s — long-lived coordinators would
        otherwise accumulate one cached client per address ever seen
        across rebalances. Safe mid-flight: a scatter already holds its
        ShardClient reference; an evicted client's kept-alive connections
        close with it."""
        horizon = time.monotonic() - ttl_s
        active = set(active_addrs)
        with self._lock:
            stale = [a for a in self._clients
                     if a not in active
                     or self._last_used.get(a, 0.0) < horizon]
            for a in stale:
                del self._clients[a]
                self._last_used.pop(a, None)
            self.evicted += len(stale)
        if stale:
            log.info("cluster: evicted %d shard client(s): %s",
                     len(stale), ", ".join(sorted(stale)))
        return len(stale)

    def scatter(self, peers: list[Peer], body: dict,
                hop_name: str) -> tuple[dict[int, object], list[int]]:
        """-> ({shard_id: result}, missing_shard_ids)."""
        hop = (self.telemetry.hop(hop_name)
               if self.telemetry is not None else None)
        if not peers:
            return {}, []
        if hop is not None:
            hop.account(emitted=len(peers))
        t0 = time.monotonic_ns()
        # trace propagation: the coordinator's context rides the shared
        # body; each peer call gets a client span recorded from the
        # fan-out worker thread (re-attached to the submitting query's
        # trace buffer — pool threads don't inherit thread-locals)
        from deepflow_tpu_torch.query import qtrace
        tbuf = qtrace.current_buf()
        tsid = qtrace.current_span_id()

        def _traced_call(client, b, peer):
            if tbuf is None:
                return client.call(b, self._attempt_pool)
            with qtrace.use_buf(tbuf, tsid):
                with qtrace.span("shard.call", shard=peer.shard_id,
                                 addr=peer.addr, op=str(b.get("op", ""))):
                    # inject inside the client span so the shard-side
                    # root parents under ITS OWN shard.call, not the
                    # shared scatter span
                    return client.call(wire.inject_ctx(b),
                                       self._attempt_pool)

        futs = {self._pool.submit(_traced_call, self.client(p.addr),
                                  body, p): p for p in peers}
        results: dict[int, object] = {}
        missing: list[int] = []
        for fut, peer in futs.items():
            try:
                results[peer.shard_id] = fut.result(
                    timeout=self.timeout_s * (2 + self.retries))
            except ShardCallError as e:
                missing.append(peer.shard_id)
                log.warning("cluster: shard %d (%s) dropped from %s: %s",
                            peer.shard_id, peer.addr, hop_name, e)
                if hop is not None:
                    hop.account(dropped=1, reason=e.reason)
            except Exception as e:   # future timeout / unexpected
                missing.append(peer.shard_id)
                log.warning("cluster: shard %d (%s) failed on %s: %s",
                            peer.shard_id, peer.addr, hop_name, e)
                if hop is not None:
                    hop.account(dropped=1, reason="error")
        if results and hop is not None:
            hop.account(delivered=len(results),
                        wait_ns=time.monotonic_ns() - t0)
        return results, sorted(missing)

    def stats(self) -> dict:
        with self._lock:
            return {addr: dict(c.stats)
                    for addr, c in sorted(self._clients.items())}

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._attempt_pool.shutdown(wait=False, cancel_futures=True)
