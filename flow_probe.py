#!/usr/bin/env python3
"""What a host offers the port's live capture, and its packet rates.

    python3 flow_probe.py        # prints one JSON object

Prints: the user, the capability sets, the interfaces and the CPU; whether
socket(AF_PACKET, SOCK_RAW) opens and binds ``lo``; whether a TPACKET_V3
ring maps on ``lo`` (by setsockopt from Python, and through the port's
``native_flow.NativeRing``), each as "ok" or the errno's name; which
packet types ``lo`` delivers for UDP and TCP frames (Linux gives an in and
an out copy of each) and what PACKET_STATISTICS reads after them; the
seconds the port's native library takes to build; and the packets/s of
the native flow map and of the Python map on chip_flows.py's bench
traffic (the native map over 20,000 flows, the Python map over a
twentieth of the packets).
"""

from __future__ import annotations

import errno
import json
import mmap
import os
import socket
import struct
import sys
import threading
import time

SOL_PACKET, PACKET_VERSION, PACKET_RX_RING = 263, 10, 5
PACKET_STATISTICS, TPACKET_V3 = 6, 2
ETH_P_ALL = 3


def _errno(e: OSError) -> str:
    return errno.errorcode.get(e.errno, str(e.errno))


def host() -> dict:
    import chip_smoke
    out = {"uid": os.getuid(), "cpus": os.cpu_count(),
           "cpu": chip_smoke._cpu_model(),
           "interfaces": [n for _, n in socket.if_nameindex()]}
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("Cap"):
                k, v = line.split(":")
                out[k] = v.strip()
    return out


def ring_by_setsockopt(s: socket.socket) -> str:
    """A TPACKET_V3 ring of four 1 MiB blocks set up and mapped."""
    bs, bn, fs = 1 << 20, 4, 2048
    try:
        s.setsockopt(SOL_PACKET, PACKET_VERSION, TPACKET_V3)
        s.setsockopt(SOL_PACKET, PACKET_RX_RING,
                     struct.pack("IIIIIII", bs, bn, fs, bs * bn // fs, 10,
                                 0, 0))
        mmap.mmap(s.fileno(), bs * bn, mmap.MAP_SHARED,
                  mmap.PROT_READ | mmap.PROT_WRITE).close()
    except OSError as e:
        return _errno(e)
    return "ok"


def lo_frames(s: socket.socket) -> dict:
    """Frames of 20 UDP datagrams and one TCP exchange over lo, counted by
    packet type, and PACKET_STATISTICS after them."""
    s.settimeout(0.2)
    u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for i in range(20):
        u.sendto(b"FLOWPROBE%03d" % i, ("127.0.0.1", 9))
    u.close()
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    tport = srv.getsockname()[1]

    def serve() -> None:
        c, _ = srv.accept()
        c.sendall(b"re:" + c.recv(64))
        c.close()
    th = threading.Thread(target=serve)
    th.start()
    with socket.create_connection(("127.0.0.1", tport)) as c:
        c.sendall(b"FLOWPROBE-TCP")
        c.recv(64)
    th.join()
    srv.close()
    seen: dict[str, int] = {}
    t0 = time.monotonic()
    while time.monotonic() - t0 < 1.5:
        try:
            frame, addr = s.recvfrom(65535)
        except socket.timeout:
            continue
        if len(frame) < 38 or frame[23] not in (6, 17):
            continue
        ports = struct.unpack(">HH", frame[34:38])
        kind = ("udp" if b"FLOWPROBE" in frame and frame[23] == 17
                else "tcp" if tport in ports else None)
        if kind:
            key = f"{kind}_pkttype{addr[2]}"
            seen[key] = seen.get(key, 0) + 1
    try:
        stats = list(struct.unpack("II", s.getsockopt(
            SOL_PACKET, PACKET_STATISTICS, 8)))
    except OSError as e:
        stats = _errno(e)
    return {"lo_frames": seen, "packet_statistics": stats}


def capture() -> dict:
    try:
        s = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                          socket.htons(ETH_P_ALL))
    except OSError as e:
        return {"af_packet": _errno(e)}
    out = {"af_packet": "ok"}
    with s:
        try:
            s.bind(("lo", 0))
        except OSError as e:
            out["bind_lo"] = _errno(e)
            return out
        out["bind_lo"] = "ok"
        out.update(lo_frames(s))
    with socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                       socket.htons(ETH_P_ALL)) as r:
        out["ring_setsockopt"] = ring_by_setsockopt(r)
    return out


def rates() -> dict:
    import chip_flows
    from deepflow_tpu_torch import native
    t0 = time.perf_counter()
    native.load()
    out = {"native_build_s": time.perf_counter() - t0}
    from deepflow_tpu_torch.agent.flow_map import FlowMap
    from deepflow_tpu_torch.agent.native_flow import NativeFlowMap, \
        NativeRing
    from deepflow_tpu_torch.agent.packet import decode_ethernet
    try:
        NativeRing("lo").close()
        out["native_ring"] = "ok"
    except OSError as e:
        out["native_ring"] = _errno(e)
    os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})
    nfm = NativeFlowMap()
    nfm.inject_batch(*chip_flows.bench_frames(100, net=9)[:3])
    data, offsets, ts, n = chip_flows.bench_frames(chip_flows.FLOWS, 10)
    t0 = time.perf_counter()
    nfm.inject_batch(data, offsets, ts)
    out["native_packets_per_s"] = n / (time.perf_counter() - t0)
    m = n // chip_flows.PY_SHARE
    frames = [(data[offsets[i]:offsets[i + 1]], int(ts[i]))
              for i in range(m)]
    fm = FlowMap()
    t0 = time.perf_counter()
    for frame, t in frames:
        fm.inject(decode_ethernet(frame, timestamp_ns=t))
    out["python_packets_per_s"] = m / (time.perf_counter() - t0)
    out["packets"], out["python_packets"] = n, m
    return out


def main() -> int:
    print(json.dumps({**host(), **capture(), **rates()}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
