"""Leader election for several servers over one store of agents.

Own copy of ``deepflow_tpu/server/election.py``. The elected leader runs
the cluster's singletons (the controller, the rollup job and the
janitor; ``server/server.py``) while every server serves ingest and
queries (reference: controller/election/election.go:175).

``LeaderElection`` holds an exclusive ``flock(2)`` on a lease file on a
shared volume: exactly one open file description holds it at any
instant, and a crashed leader's lock goes with its process, so no expiry
is needed. A fencing token in the file's body increments under the lock,
so downstream systems can refuse a deposed leader's writes.
``K8sLeaseElection`` does the same over a ``coordination.k8s.io/v1``
Lease where there is no shared volume: GET, then acquire when the lease
is absent, expired by this candidate's own clock, or its own, with the
apiserver's resourceVersion arbitrating races (a conflict loses with a
409). Both have the same callbacks and flags.

``in_cluster_config`` and ``build_api_context`` come from
``server/genesis.py``, as in the reference: the pod's service-account
token and CA, and a TLS context that verifies, or skips verification
only when told to, with a warning.
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import socket
import threading
import time

from deepflow_tpu_torch.server.genesis import build_api_context, \
    in_cluster_config

log = logging.getLogger("df.election")


class LeaderElection:
    def __init__(self, lease_path: str, holder: str | None = None,
                 ttl_s: float = 10.0, renew_interval_s: float = 3.0,
                 on_elected=None, on_deposed=None) -> None:
        self.lease_path = lease_path
        if holder is None:
            import uuid
            # instance-unique: two candidates in ONE process (tests,
            # embedded multi-server) must never share an identity
            holder = (f"{socket.gethostname()}-{os.getpid()}-"
                      f"{uuid.uuid4().hex[:8]}")
        self.holder = holder
        self.ttl_s = ttl_s  # kept for API compat; flock needs no TTL
        self.renew_interval_s = renew_interval_s
        self.on_elected = on_elected or (lambda: None)
        self.on_deposed = on_deposed or (lambda: None)
        self.is_leader = False
        self.token = 0          # fencing token of OUR leadership
        self._fd: int | None = None
        self._acquire_lock = threading.Lock()  # ticks + manual calls race
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stats = {"elections": 0, "renewals": 0, "depositions": 0}

    # -- protocol --------------------------------------------------------------

    def try_acquire(self) -> bool:
        """One acquire attempt; returns current leadership. Holding the
        flock IS leadership — renewal is a no-op heartbeat. Serialized:
        a concurrent losing attempt must never depose a winning one."""
        with self._acquire_lock:
            return self._try_acquire_locked()

    def _try_acquire_locked(self) -> bool:
        if self.is_leader and self._fd is not None:
            self.stats["renewals"] += 1
            return True
        try:
            fd = os.open(self.lease_path, os.O_RDWR | os.O_CREAT, 0o644)
        except OSError as e:
            log.warning("lease open failed: %s", e)
            return self._set_leader(False)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return self._set_leader(False)
        # we own the lock: bump the fencing token and record identity
        try:
            raw = os.pread(fd, 4096, 0)
            prev = json.loads(raw) if raw.strip() else {}
        except (OSError, ValueError):
            prev = {}
        self.token = int(prev.get("token", 0)) + 1
        body = json.dumps({"holder": self.holder, "token": self.token,
                           "acquired_ns": time.time_ns()}).encode()
        try:
            os.ftruncate(fd, 0)
            os.pwrite(fd, body, 0)
            os.fsync(fd)
        except OSError as e:
            log.warning("lease write failed: %s", e)
        self._fd = fd
        return self._set_leader(True)

    def _set_leader(self, leader: bool) -> bool:
        if leader and not self.is_leader:
            self.is_leader = True
            self.stats["elections"] += 1
            log.info("elected leader (%s, token=%d)", self.holder,
                     self.token)
            try:
                self.on_elected()
            except Exception:
                log.exception("on_elected failed")
        elif not leader and self.is_leader:
            self.is_leader = False
            self.stats["depositions"] += 1
            log.warning("leadership lost (%s)", self.holder)
            try:
                self.on_deposed()
            except Exception:
                log.exception("on_deposed failed")
        return self.is_leader

    def resign(self) -> None:
        """Graceful handoff: release the lock so a follower wins at once."""
        with self._acquire_lock:
            self._resign_locked()

    def _resign_locked(self) -> None:
        fd, self._fd = self._fd, None
        if fd is not None:
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            except OSError:
                pass
            os.close(fd)
        self._set_leader(False)

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "LeaderElection":
        self.try_acquire()
        self._thread = threading.Thread(
            target=self._run, name="df-election", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
        self.resign()

    def _run(self) -> None:
        while not self._stop.wait(self.renew_interval_s):
            try:
                self.try_acquire()
            except Exception:
                log.exception("election tick failed")


class K8sLeaseElection:
    """Leader election over coordination.k8s.io/v1 Lease objects — for
    deployments with no shared volume (the flock path needs one). Exactly
    the reference's mechanism (election.go:175): GET the Lease, acquire if
    absent/expired/ours, renew by updating renewTime, with the apiserver's
    optimistic concurrency (resourceVersion) arbitrating races —
    a conflicting update loses with a 409, never yielding two leaders.

    Same callback/flag surface as LeaderElection so Server can use either.
    """

    def __init__(self, name: str, namespace: str = "default",
                 api_base: str | None = None, token: str = "",
                 ca_path: str = "", holder: str | None = None,
                 ttl_s: float = 15.0, renew_interval_s: float = 5.0,
                 on_elected=None, on_deposed=None,
                 insecure_skip_verify: bool = False) -> None:
        if api_base is None:
            cfg = in_cluster_config()
            if cfg is None:
                raise RuntimeError("not in a cluster and no api_base given")
            api_base, token, ca_path = cfg
        self.api_base = api_base.rstrip("/")
        self._bearer = token        # NEVER in .token: that's the fencing
        # int (shared _set_leader logs it with %d)
        self._ctx = build_api_context(self.api_base, ca_path,
                                      insecure_skip_verify)
        self.name = name
        self.namespace = namespace
        if holder is None:
            import uuid
            holder = (f"{socket.gethostname()}-{os.getpid()}-"
                      f"{uuid.uuid4().hex[:8]}")
        self.holder = holder
        self.ttl_s = ttl_s
        self.renew_interval_s = renew_interval_s
        self.on_elected = on_elected or (lambda: None)
        self.on_deposed = on_deposed or (lambda: None)
        self.is_leader = False
        self.token = 0           # fencing (leaseTransitions), like flock's
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._acquire_lock = threading.Lock()
        # clock-skew-safe expiry (client-go style): time the lease from
        # when WE first observed its renewTime, by our monotonic clock
        self._observed_renew = ("", 0.0)   # (renewTime str, seen_monotonic)
        self._last_ok = 0.0
        self.stats = {"elections": 0, "renewals": 0, "depositions": 0,
                      "conflicts": 0, "errors": 0}

    @property
    def token_fencing(self) -> int:  # back-compat alias
        return self.token

    # -- k8s api ---------------------------------------------------------------

    def _url(self) -> str:
        return (f"{self.api_base}/apis/coordination.k8s.io/v1/namespaces/"
                f"{self.namespace}/leases/{self.name}")

    def _req(self, method: str, body: dict | None = None):
        import urllib.request
        data = json.dumps(body).encode() if body is not None else None
        url = self._url() if method != "POST" else (
            f"{self.api_base}/apis/coordination.k8s.io/v1/namespaces/"
            f"{self.namespace}/leases")
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        if self._bearer:
            req.add_header("Authorization", f"Bearer {self._bearer}")
        with urllib.request.urlopen(req, timeout=5,
                                    context=self._ctx) as r:
            return json.load(r)

    @staticmethod
    def _now_rfc3339() -> str:
        import datetime
        return datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%S.%f") + "Z"

    # -- protocol --------------------------------------------------------------

    def try_acquire(self) -> bool:
        with self._acquire_lock:
            try:
                out = self._try_acquire_locked()
                self._last_ok = time.monotonic()
                return out
            except Exception as e:
                self.stats["errors"] += 1
                # a transient apiserver blip must not flap the singletons:
                # the lease is still validly OURS until its ttl passes, so
                # keep leading within that grace window (client-go retries
                # inside the renew deadline the same way)
                if self.is_leader and \
                        time.monotonic() - self._last_ok < self.ttl_s:
                    log.warning("k8s lease renew error (still within "
                                "ttl grace): %s", e)
                    return True
                log.warning("k8s lease election error: %s", e)
                return self._set_leader(False)

    def _try_acquire_locked(self) -> bool:
        import urllib.error
        try:
            lease = self._req("GET")
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
            # no lease yet: CREATE arbitrates the race (409 loses)
            try:
                self._req("POST", self._body(transitions=1))
                self.token = 1
                return self._set_leader(True)
            except urllib.error.HTTPError as ce:
                if ce.code == 409:
                    self.stats["conflicts"] += 1
                    return self._set_leader(False)
                raise
        spec = lease.get("spec", {})
        holder = spec.get("holderIdentity", "")
        renew_str = spec.get("renewTime", "") or ""
        ttl = float(spec.get("leaseDurationSeconds", self.ttl_s))
        # skew-safe: expire ttl after WE first saw this renewTime value
        # (remote clocks may disagree with ours by more than the ttl)
        now_mono = time.monotonic()
        if renew_str != self._observed_renew[0]:
            self._observed_renew = (renew_str, now_mono)
        expired = (now_mono - self._observed_renew[1]) > ttl or \
            not renew_str
        if holder != self.holder and not expired:
            return self._set_leader(False)
        transitions = int(spec.get("leaseTransitions", 0))
        if holder != self.holder:
            transitions += 1
        body = self._body(transitions=transitions)
        body["metadata"]["resourceVersion"] = \
            lease["metadata"].get("resourceVersion", "")
        try:
            self._req("PUT", body)
        except urllib.error.HTTPError as ce:
            if ce.code == 409:  # another candidate won the update race
                self.stats["conflicts"] += 1
                return self._set_leader(False)
            raise
        self.token = transitions
        if holder == self.holder:
            self.stats["renewals"] += 1
        return self._set_leader(True)

    def _body(self, transitions: int) -> dict:
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": {
                "holderIdentity": self.holder,
                "leaseDurationSeconds": int(self.ttl_s),
                "renewTime": self._now_rfc3339(),
                "leaseTransitions": transitions,
            },
        }

    _set_leader = LeaderElection._set_leader

    def resign(self) -> None:
        with self._acquire_lock:
            if self.is_leader:
                try:
                    lease = self._req("GET")
                    spec = lease.get("spec", {})
                    if spec.get("holderIdentity") == self.holder:
                        body = self._body(
                            transitions=int(
                                spec.get("leaseTransitions", 0)))
                        del body["spec"]["renewTime"]  # absent renewTime
                        # == expired NOW (the skew-safe observer ignores
                        # timestamp VALUES, but treats a missing one as
                        # immediately expired)
                        body["metadata"]["resourceVersion"] = \
                            lease["metadata"].get("resourceVersion", "")
                        self._req("PUT", body)
                except Exception as e:
                    # failed expiry-PUT delays failover by up to ttl_s:
                    # that must be diagnosable
                    log.warning("lease resign write failed (followers "
                                "wait out the ttl): %s", e)
            self._set_leader(False)

    # -- lifecycle (same shape as LeaderElection) ------------------------------

    start = LeaderElection.start
    stop = LeaderElection.stop
    _run = LeaderElection._run
