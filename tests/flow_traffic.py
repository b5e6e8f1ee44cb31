"""Seeded synthetic traffic for the flow tests: raw Ethernet frames with
their capture times, built with the port's frame encoders (the JAX
package's give the same bytes).

``synthetic(seed, n_flows)`` mixes, per flow:
- HTTP/1.1 sessions with pipelined requests (two requests before the
  responses), 200s and a share of 500s, closed by a FIN pair;
- Redis over TCP and DNS over UDP (a share answered NXDOMAIN);
- retransmitted data segments and zero windows;
- RST closes mid-stream;
- flows left open (timed out by ``tick``), half-closed ones and bare SYNs;
- unparseable payloads to one endpoint from many clients, which exhaust
  the L7 inference budget and then its per-endpoint negative cache.
"""

from __future__ import annotations

import struct

import numpy as np

from deepflow_tpu_torch.agent.packet import (
    TcpFlags, encode_tcp_frame, encode_udp_frame)

T0 = 1_700_000_000_000_000_000
S_, A_, F_, R_, P_ = (TcpFlags.SYN, TcpFlags.ACK, TcpFlags.FIN,
                      TcpFlags.RST, TcpFlags.PSH)
KINDS = ("http", "http", "http", "redis", "dns", "retrans", "rst", "open",
         "half", "syn", "junk", "junk")


def _http_req(i: int) -> bytes:
    return (f"GET /api/v1/item?id={i} HTTP/1.1\r\nHost: svc.local\r\n"
            f"X-Request-ID: req-{i}\r\n\r\n").encode()


def _http_resp(code: int) -> bytes:
    reason = {200: "OK", 500: "Internal Server Error"}[code]
    return (f"HTTP/1.1 {code} {reason}\r\nContent-Length: 2\r\n\r\nok"
            ).encode()


def _dns(qid: int, name: str, response: bool, rcode: int = 0) -> bytes:
    flags = (0x8180 | rcode) if response else 0x0100
    q = b"".join(bytes([len(p)]) + p.encode() for p in name.split("."))
    return struct.pack(">HHHHHH", qid, flags, 1, 0, 0, 0) + q + \
        b"\x00" + struct.pack(">HH", 1, 1)


class _Flow:
    """One TCP conversation's frames, stamped from ``t`` on."""

    def __init__(self, out: list, c: str, s: str, cp: int, sp: int,
                 t: int, gap: int) -> None:
        self.out, self.c, self.s, self.cp, self.sp = out, c, s, cp, sp
        self.t, self.gap = t, gap
        self.cseq, self.sseq = 1000, 5000

    def c2s(self, flags, payload=b"", seq=None, window=65535) -> None:
        self.out.append((encode_tcp_frame(
            self.c, self.s, self.cp, self.sp, flags, payload,
            self.cseq if seq is None else seq, self.sseq, window), self.t))
        if seq is None:
            self.cseq += len(payload)
        self.t += self.gap

    def s2c(self, flags, payload=b"", window=65535) -> None:
        self.out.append((encode_tcp_frame(
            self.s, self.c, self.sp, self.cp, flags, payload, self.sseq,
            self.cseq, window), self.t))
        self.sseq += len(payload)
        self.t += self.gap

    def handshake(self) -> None:
        self.c2s(S_)
        self.s2c(S_ | A_)
        self.c2s(A_)

    def fin(self) -> None:
        self.c2s(F_ | A_)
        self.s2c(F_ | A_)


def synthetic(seed: int, n_flows: int = 240) -> list[tuple[bytes, int]]:
    """The frames of ``n_flows`` flows, sorted by capture time."""
    rng = np.random.default_rng(seed)
    out: list[tuple[bytes, int]] = []
    for i in range(n_flows):
        kind = KINDS[int(rng.integers(len(KINDS)))]
        c = f"10.{seed % 200}.{i >> 8 & 255}.{i & 255}"
        s = f"10.200.0.{int(rng.integers(1, 6))}"
        cp = 30000 + i
        t = T0 + int(rng.integers(0, 3_000_000_000))
        gap = int(rng.integers(50_000, 2_000_000))
        if kind == "dns":
            qid = int(rng.integers(1, 65535))
            name = f"h{i}.svc.local"
            out.append((encode_udp_frame(c, s, cp, 53,
                                         _dns(qid, name, False)), t))
            if rng.random() < 0.8:
                rc = 3 if rng.random() < 0.3 else 0
                out.append((encode_udp_frame(s, c, 53, cp,
                                             _dns(qid, name, True, rc)),
                            t + gap))
            continue
        port = {"http": 80, "retrans": 8080, "rst": 80, "open": 8080,
                "half": 80, "syn": 443, "redis": 6379, "junk": 9999}[kind]
        f = _Flow(out, c, s, cp, port, t, gap)
        if kind == "syn":
            f.c2s(S_)
            continue
        f.handshake()
        if kind == "redis":
            for k in range(int(rng.integers(1, 4))):
                f.c2s(A_ | P_, f"*2\r\n$3\r\nGET\r\n$4\r\nk{k:03d}\r\n"
                      .encode())
                f.s2c(A_ | P_, b"$3\r\nval\r\n")
            f.fin()
        elif kind == "junk":
            # past the flow's inference attempts, to one endpoint
            f.s = "10.200.0.9"
            for _ in range(int(rng.integers(5, 8))):
                f.c2s(A_ | P_, bytes(rng.integers(
                    128, 256, int(rng.integers(8, 64)), dtype=np.uint8)))
            f.fin()
        else:
            n_req = int(rng.integers(1, 4))
            reqs = [_http_req(i * 10 + k) for k in range(n_req)]
            # pipelined: the first two requests go out before a response
            f.c2s(A_ | P_, reqs[0])
            if n_req > 1:
                f.c2s(A_ | P_, reqs[1])
            for k in range(n_req):
                if k >= 2:
                    f.c2s(A_ | P_, reqs[k])
                if kind == "retrans" and k == 0:
                    f.c2s(A_ | P_, reqs[0], seq=1000)   # behind the mark
                    f.s2c(A_, window=0)                   # zero window
                f.s2c(A_ | P_, _http_resp(500 if rng.random() < 0.2
                                          else 200))
            if kind == "rst":
                f.c2s(R_)
            elif kind == "half":
                f.c2s(F_ | A_)
            elif kind != "open":
                f.fin()
    out.sort(key=lambda p: p[1])
    return out


def windows(frames: list, step_ns: int = 1_000_000_000):
    """(frames, end ns) per ``step_ns`` window of capture time, in order;
    empty windows are kept, so ticks run at every boundary."""
    if not frames:
        return []
    first, last = frames[0][1], frames[-1][1]
    out = []
    lo = first - first % step_ns
    i = 0
    while lo <= last:
        hi = lo + step_ns
        j = i
        while j < len(frames) and frames[j][1] < hi:
            j += 1
        out.append((frames[i:j], hi))
        i, lo = j, hi
    return out
