"""The control plane's transport: protobuf bodies over HTTP/1.1.

The reference serves its ``deepflow_tpu.Synchronizer`` service on gRPC
(``deepflow_tpu/server/controller.py:683-758``); the card's machine has no
``grpcio``, so the port carries the same messages (``proto/wire.py``) on
the standard library: ``POST /deepflow_tpu.Synchronizer/<Method>`` with
the request's protobuf bytes as the body and the response's as the
answer (``application/x-protobuf``), on the reference's sync port 20035.
The methods are ``Sync``, ``Ntp``, ``GpidSync``, ``PromEncode``,
``PodMap`` and ``Push``. ``Push`` is the reference's server stream as a long poll: the
request names the config version the agent holds, and the answer comes
as soon as the agent's group has another (within a second of the bump),
or, after ``PUSH_HOLD_S`` with no change, as ``204 No Content``, after
which the agent asks again.

``SyncWireServer`` runs on asyncio streams, one coroutine per connection
and per held push, not a thread (the reference moved to ``grpc.aio``
because a thread pool capped it at 48 push streams); connections are kept
alive. ``SyncClient`` is the agent's side: blocking, one kept-alive
connection, reconnecting once when the server closed an idle one. A
status other than 200 or 204 raises ``SyncError`` with the server's
message.
"""

from __future__ import annotations

import asyncio
import http.client
import logging
import socket
import threading

from deepflow_tpu_torch.proto import wire

log = logging.getLogger("df.syncwire")

SERVICE = "deepflow_tpu.Synchronizer"
DEFAULT_SYNC_PORT = 20035
METHODS = {
    "Sync": (wire.SyncRequest, wire.SyncResponse),
    "Ntp": (wire.NtpRequest, wire.NtpResponse),
    "GpidSync": (wire.GpidSyncRequest, wire.GpidSyncResponse),
    "PromEncode": (wire.PromEncodeRequest, wire.PromEncodeResponse),
    "PodMap": (wire.PodMapRequest, wire.PodMapResponse),
    "Push": (wire.SyncRequest, wire.SyncResponse),
}
MAX_BODY = 80 << 20          # the reference's gRPC message cap
MAX_HEAD = 64 << 10
PUSH_HOLD_S = 30.0           # a held push answers 204 after this
_REASONS = {200: "OK", 204: "No Content", 400: "Bad Request",
            404: "Not Found", 405: "Method Not Allowed",
            413: "Payload Too Large", 431: "Request Header Fields Too Large",
            500: "Internal Server Error"}


class SyncError(RuntimeError):
    """The controller answered with an error, or could not be reached."""


def method_path(name: str) -> str:
    return f"/{SERVICE}/{name}"


class SyncWireServer:
    """Serves ``handlers`` (method name -> callable taking the decoded
    request and returning the response, a coroutine of it, or None for
    204) on ``host:port``; ``start`` and ``stop`` run on the server's own
    event loop."""

    def __init__(self, handlers: dict, host: str = "127.0.0.1",
                 port: int = DEFAULT_SYNC_PORT) -> None:
        unknown = set(handlers) - set(METHODS)
        if unknown:
            raise ValueError(f"no such methods: {sorted(unknown)}")
        self.handlers = handlers
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None
        self._tasks: set[asyncio.Task] = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._connection, self.host, self.port, limit=MAX_HEAD)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for t in list(self._tasks):
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._tasks.add(task)
        try:
            while await self._one_request(reader, writer):
                pass
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._tasks.discard(task)
            writer.close()

    async def _one_request(self, reader, writer) -> bool:
        """Read, answer and flush one request; False when the
        connection is done."""
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError:
            return False
        except asyncio.LimitOverrunError:
            await self._reply(writer, 431, b"request head too large")
            return False
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3:
            await self._reply(writer, 400, b"bad request line")
            return False
        verb, path, version = parts
        headers = {}
        for line in lines[1:]:
            k, sep, v = line.partition(":")
            if sep:
                headers[k.strip().lower()] = v.strip()
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            await self._reply(writer, 400, b"bad content-length")
            return False
        if not 0 <= length <= MAX_BODY:
            await self._reply(writer, 413, b"body too large")
            return False
        body = await reader.readexactly(length)
        status, out = await self._dispatch(verb, path, body)
        await self._reply(writer, status, out)
        return version == "HTTP/1.1" and \
            headers.get("connection", "").lower() != "close"

    async def _dispatch(self, verb: str, path: str,
                        body: bytes) -> tuple[int, bytes]:
        prefix = f"/{SERVICE}/"
        name = path[len(prefix):] if path.startswith(prefix) else ""
        if name not in self.handlers:
            return 404, f"no method {path}".encode()
        if verb != "POST":
            return 405, b"POST only"
        try:
            request = METHODS[name][0].FromString(body)
        except (wire.WireError, UnicodeDecodeError) as e:
            return 400, f"bad {name} request: {e}".encode()
        try:
            out = self.handlers[name](request)
            if asyncio.iscoroutine(out):
                out = await out
        except asyncio.CancelledError:
            raise
        except Exception as e:  # the connection outlives one bad call
            log.exception("sync method %s failed", name)
            return 500, f"{name}: {type(e).__name__}: {e}".encode()
        if out is None:
            return 204, b""
        return 200, out.SerializeToString()

    @staticmethod
    async def _reply(writer, status: int, body: bytes) -> None:
        ctype = ("application/x-protobuf" if status == 200
                 else "text/plain; charset=utf-8")
        head = (f"HTTP/1.1 {status} {_REASONS.get(status, '')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n\r\n").encode()
        writer.write(head + body)
        await writer.drain()


class SyncClient:
    """One kept-alive connection to a controller; ``call`` is
    thread-safe (calls queue on the connection)."""

    def __init__(self, addr: str, timeout_s: float = 5.0) -> None:
        host, sep, port = addr.rpartition(":")
        if not sep:
            host, port = addr, str(DEFAULT_SYNC_PORT)
        try:
            self.host, self.port = host or "127.0.0.1", int(port)
        except ValueError:
            raise ValueError(f"bad controller address {addr!r}: expected "
                             "host[:port]") from None
        self.timeout_s = timeout_s
        self._conn: http.client.HTTPConnection | None = None
        self._lock = threading.Lock()
        self._aborted = False

    def call(self, method: str, request, timeout_s: float | None = None):
        """The method's response, or None for a push that held with no
        change (204)."""
        body = request.SerializeToString()
        timeout = self.timeout_s if timeout_s is None else timeout_s
        with self._lock:
            for attempt in (0, 1):
                reused = self._conn is not None
                try:
                    conn = self._connection(timeout)
                    conn.sock.settimeout(timeout)
                    conn.request("POST", method_path(method), body,
                                 {"Content-Type": "application/x-protobuf"})
                    r = conn.getresponse()
                    data = r.read()
                    status = r.status
                except (http.client.HTTPException, OSError) as e:
                    self._close_locked()
                    if reused and attempt == 0 and not self._aborted \
                            and not isinstance(e, TimeoutError):
                        continue  # the server closed an idle connection
                    raise SyncError(f"{method} to {self.host}:{self.port}"
                                    f": {type(e).__name__}: {e}") from e
                break
        if status == 204:
            return None
        if status != 200:
            raise SyncError(f"{method}: {status} "
                            f"{data.decode('utf-8', 'replace')}")
        return METHODS[method][1].FromString(data)

    def local_ip(self, timeout_s: float | None = None) -> str:
        """This host's address on its connection to the controller (the
        agent's control-plane address; no name lookup). Connects when no
        connection is open; raises SyncError when that fails."""
        with self._lock:
            try:
                conn = self._connection(timeout_s)
                return conn.sock.getsockname()[0]
            except OSError as e:
                self._close_locked()
                raise SyncError(f"connect to {self.host}:{self.port}: "
                                f"{e}") from e

    def _connection(self, timeout_s: float | None = None
                    ) -> http.client.HTTPConnection:
        if self._conn is None:
            conn = http.client.HTTPConnection(
                self.host, self.port,
                timeout=self.timeout_s if timeout_s is None else timeout_s)
            conn.connect()
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conn = conn
        return self._conn

    def _close_locked(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()

    def abort(self) -> None:
        """Unblock a call waiting on the connection (a held push) from
        another thread: its call raises SyncError, and no call retries
        from here on."""
        self._aborted = True
        conn = self._conn
        sock = conn.sock if conn is not None else None
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def close(self) -> None:
        self.abort()
        with self._lock:
            self._close_locked()
