"""A single-node Kafka broker on a local port, for the Kafka exporter's
tests and the smoke's ``integrations`` phase.

It decodes the requests with its own struct unpacking (independent of
``utils/kafkawire.py``'s builders), checks each message's CRC, and
answers Metadata v0 and Produce v2 as a one-broker cluster would, with
``n_partitions`` partitions it leads. ``produce_errors`` are the error
codes its next produce answers carry (0 after them); ``messages`` holds
each partition's message values. Every socket wait is bounded: accept
wakes every 0.5 s, a connection times out after 5 s, and ``stop`` joins
within 5 s.
"""

import socket
import struct
import threading
import zlib


class StubBroker(threading.Thread):
    def __init__(self, n_partitions: int = 2, produce_errors=None):
        super().__init__(daemon=True)
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.sock.settimeout(0.5)  # accept wakes to see stop()
        self.port = self.sock.getsockname()[1]
        self.n_partitions = n_partitions
        self.produce_errors = list(produce_errors or [])
        self.messages: dict[int, list[bytes]] = {}
        self.crc_failures = 0
        self.api_versions_seen: list[tuple[int, int]] = []
        self._stopping = False

    def run(self) -> None:
        while not self._stopping:
            try:
                conn, _ = self.sock.accept()
            except TimeoutError:
                continue
            except OSError:
                return
            conn.settimeout(5.0)
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def stop(self) -> None:
        self._stopping = True
        try:
            self.sock.close()
        except OSError:
            pass
        self.join(timeout=5.0)

    def _recv_exact(self, conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _handle(self, conn) -> None:
        try:
            while True:
                hdr = self._recv_exact(conn, 4)
                if hdr is None:
                    return
                size = struct.unpack(">i", hdr)[0]
                data = self._recv_exact(conn, size)
                if data is None:
                    return
                api_key, api_ver, corr = struct.unpack(">hhi", data[:8])
                self.api_versions_seen.append((api_key, api_ver))
                pos = 8
                cid_len = struct.unpack(">h", data[pos:pos + 2])[0]
                pos += 2 + max(cid_len, 0)
                if api_key == 3:
                    conn.sendall(self._metadata_response(corr, data[pos:]))
                elif api_key == 0:
                    conn.sendall(self._produce_response(corr, data[pos:]))
                else:
                    return
        except OSError:
            pass
        finally:
            conn.close()

    def _metadata_response(self, corr: int, body: bytes) -> bytes:
        (n_topics,) = struct.unpack(">i", body[:4])
        pos = 4
        topics = []
        for _ in range(n_topics):
            tlen = struct.unpack(">h", body[pos:pos + 2])[0]
            topics.append(body[pos + 2:pos + 2 + tlen].decode())
            pos += 2 + tlen
        out = struct.pack(">i", 1)  # one broker: us
        out += struct.pack(">i", 0)
        host = b"127.0.0.1"
        out += struct.pack(">h", len(host)) + host
        out += struct.pack(">i", self.port)
        out += struct.pack(">i", len(topics))
        for t in topics:
            out += struct.pack(">h", 0)  # topic error
            tb = t.encode()
            out += struct.pack(">h", len(tb)) + tb
            out += struct.pack(">i", self.n_partitions)
            for pid in range(self.n_partitions):
                out += struct.pack(">hiii", 0, pid, 0, 1)  # leader=0
                out += struct.pack(">i", 0)                # replicas[0]
                out += struct.pack(">i", 1)                # isr count
                out += struct.pack(">i", 0)
        payload = struct.pack(">i", corr) + out
        return struct.pack(">i", len(payload)) + payload

    def _produce_response(self, corr: int, body: bytes) -> bytes:
        acks, timeout_ms, n_topics = struct.unpack(">hii", body[:10])
        assert acks == 1 and n_topics == 1
        pos = 10
        tlen = struct.unpack(">h", body[pos:pos + 2])[0]
        topic = body[pos + 2:pos + 2 + tlen].decode()
        pos += 2 + tlen
        (n_parts,) = struct.unpack(">i", body[pos:pos + 4])
        assert n_parts == 1
        pos += 4
        partition, set_size = struct.unpack(">ii", body[pos:pos + 8])
        pos += 8
        msg_set = body[pos:pos + set_size]
        # walk the message set: offset i64, size i32, crc u32, magic, attrs,
        # timestamp i64, key bytes, value bytes
        mpos = 0
        base = len(self.messages.get(partition, []))
        while mpos < len(msg_set):
            _, msize = struct.unpack(">qi", msg_set[mpos:mpos + 12])
            msg = msg_set[mpos + 12:mpos + 12 + msize]
            (crc,) = struct.unpack(">I", msg[:4])
            if zlib.crc32(msg[4:]) & 0xFFFFFFFF != crc:
                self.crc_failures += 1
            magic, attrs = struct.unpack(">bb", msg[4:6])
            assert magic == 1 and attrs == 0
            p = 6 + 8  # skip timestamp
            (klen,) = struct.unpack(">i", msg[p:p + 4])
            p += 4 + max(klen, 0)
            (vlen,) = struct.unpack(">i", msg[p:p + 4])
            value = msg[p + 4:p + 4 + vlen]
            self.messages.setdefault(partition, []).append(value)
            mpos += 12 + msize
        err = self.produce_errors.pop(0) if self.produce_errors else 0
        tb = topic.encode()
        out = struct.pack(">i", 1)
        out += struct.pack(">h", len(tb)) + tb
        out += struct.pack(">i", 1)
        out += struct.pack(">ihqq", partition, err, base, -1)
        out += struct.pack(">i", 0)  # throttle_time_ms
        payload = struct.pack(">i", corr) + out
        return struct.pack(">i", len(payload)) + payload
