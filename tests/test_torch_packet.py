"""The port's packet decode (``agent/packet.py`` and the native batch
decoder of ``native/dfnative.cpp``) held against the JAX package's on
the same bytes: the tunnel frames of ``tests/test_decap.py`` (VXLAN,
GENEVE, GRE, ERSPAN I, II and III), IPv6, VLAN, odd UDP and GRE, every
truncation of each and seeded byte flips, and ``read_pcap`` of every
golden capture, through the Python decoder and the native one."""

import dataclasses
import os
import struct

import numpy as np
import pytest

import test_decap as td
from deepflow_tpu import native as ref_native
from deepflow_tpu.agent import packet as ref_packet
from deepflow_tpu_torch import native
from deepflow_tpu_torch.agent import packet

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "pcaps")
PCAPS = sorted(fn[:-5] for fn in os.listdir(FIXTURE_DIR)
               if fn.endswith(".pcap"))

V6_A = b"\x20\x01" + b"\x00" * 13 + b"\x01"
V6_B = b"\x20\x01" + b"\x00" * 13 + b"\x02"
OUTER = (bytes([172, 16, 0, 1]), bytes([172, 16, 0, 2]))


def _erspan3_frame(session: int = 9) -> bytes:
    gre = struct.pack(">HH", 0, 0x22EB)
    ers = struct.pack(">HHII", 0x2000, session & 0x3FF, 0, 0)
    return td.eth(0x0800, td.ipv4(47, *OUTER, gre + ers + td.INNER))


def _vlan(frame: bytes, vid: int = 42) -> bytes:
    return frame[:12] + struct.pack(">HH", 0x8100, vid) + frame[12:]


def _v6_tcp() -> bytes:
    return td.eth(0x86DD, td.ipv6(6, V6_A, V6_B,
                                  td.tcp(50000, 443, b"v6-payload")))


def _vxlan_v6_inner() -> bytes:
    inner6 = td.eth(0x86DD, td.ipv6(6, V6_A, V6_B, td.tcp(5, 443, b"x")))
    hdr = struct.pack(">BBHI", 0x08, 0, 0, 66 << 8)
    return td.eth(0x0800, td.ipv4(17, *OUTER, td.udp(49152, 4789,
                                                     hdr + inner6)))


FRAMES = {
    **{name: frame for name, frame, _, _ in td.CASES},
    "erspan3": _erspan3_frame(),
    "gre-no-key": td.gre_teb_frame(key=None),
    "geneve-3-option-words": td.geneve_frame(n_opts_words=3),
    "vlan-tcp": _vlan(td.INNER),
    "vlan-vxlan": _vlan(td.vxlan_frame()),
    "ipv6-tcp": _v6_tcp(),
    "ipv6-udp": td.eth(0x86DD, td.ipv6(17, V6_A, V6_B,
                                       td.udp(53, 5353, b"q"))),
    "ipv6-icmp": td.eth(0x86DD, td.ipv6(58, V6_A, V6_B, b"\x80\x00ping")),
    "vxlan-ipv6-inner": _vxlan_v6_inner(),
    "vxlan-in-vxlan": td.eth(0x0800, td.ipv4(17, *OUTER, td.udp(
        1, 4789, struct.pack(">BBHI", 0x08, 0, 0, 5 << 8)
        + td.vxlan_frame(6)))),
    "udp": td.eth(0x0800, td.ipv4(17, bytes([10, 0, 0, 1]),
                                  bytes([10, 0, 0, 2]),
                                  td.udp(1111, 2222, b"dns-ish"))),
    "vxlan-without-i-flag": td.eth(0x0800, td.ipv4(17, b"\1\1\1\1",
                                                   b"\2\2\2\2", td.udp(
        5, 4789, struct.pack(">BBHI", 0, 0, 0, 1 << 8) + td.INNER))),
    "plain-gre": td.eth(0x0800, td.ipv4(47, *OUTER, struct.pack(
        ">HH", 0, 0x0800) + td.INNER[14:])),
    "icmp": td.eth(0x0800, td.ipv4(1, b"\1\1\1\1", b"\2\2\2\2",
                                   b"\x08\x00echo")),
    "arp": td.eth(0x0806, b"\x00" * 28),
    "tcp-options": td.eth(0x0800, td.ipv4(6, b"\1\1\1\1", b"\2\2\2\2",
                                          struct.pack(">HHIIBBHHH", 1, 2,
                                                      3, 4, 8 << 4, 0x12,
                                                      9, 0, 0)
                                          + b"\x01" * 12 + b"after")),
}


def _fields(mp) -> dict | None:
    return None if mp is None else dataclasses.asdict(mp)


def _native_rows(decode, frames: list[bytes]) -> list:
    """(ok, record fields) per frame of a native batch decoder."""
    recs, ok = decode(frames)
    names = [n for n in recs.dtype.names if n != "_pad"]
    return [(bool(o), tuple(r[n].item() for n in names) if o else None)
            for r, o in zip(recs, ok)]


def _variants(frame: bytes, seed: int) -> list[bytes]:
    """Every truncation of the frame, and a few seeded byte flips."""
    rng = np.random.default_rng(seed)
    out = [frame[:n] for n in range(len(frame) + 1)]
    for _ in range(40):
        b = bytearray(frame)
        for i in rng.integers(0, len(b), int(rng.integers(1, 4))):
            b[i] = int(rng.integers(0, 256))
        out.append(bytes(b))
    return out


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_decode_equals_reference(name):
    frame = FRAMES[name]
    for ts, tap in ((0, 0), (1_700_000_000_123_456_789, 7)):
        assert _fields(packet.decode_ethernet(frame, ts, tap)) == \
            _fields(ref_packet.decode_ethernet(frame, ts, tap))
    assert _native_rows(native.decode_eth_batch, [frame]) == \
        _native_rows(ref_native.decode_eth_batch, [frame])


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_truncated_and_malformed_decode_equals_reference(name):
    frames = _variants(FRAMES[name], seed=sorted(FRAMES).index(name))
    for f in frames:
        assert _fields(packet.decode_ethernet(f, 5)) == \
            _fields(ref_packet.decode_ethernet(f, 5)), f.hex()
    assert _native_rows(native.decode_eth_batch, frames) == \
        _native_rows(ref_native.decode_eth_batch, frames)


def test_tunnel_stamps_and_wire_length():
    """The reference's expectations of the tunnel cases, on the port."""
    for name, frame, ttype, tid in td.CASES:
        mp = packet.decode_ethernet(frame, 1)
        assert (mp.protocol, mp.port_src, mp.port_dst, mp.payload) == \
            (1, 40000, 443, b"inner-payload"), name
        assert (mp.tunnel_type, mp.tunnel_id) == (ttype, tid), name
        assert mp.packet_len == len(frame)
    mp = packet.decode_ethernet(FRAMES["erspan3"], 1)
    assert (mp.tunnel_type, mp.tunnel_id) == (3, 9)
    recs, ok = native.decode_eth_batch([FRAMES["vxlan-ipv6-inner"]])
    assert not ok[0]   # the native path leaves inner IPv6 to Python
    mp = packet.decode_ethernet(FRAMES["vxlan-ipv6-inner"], 1)
    assert (mp.tunnel_type, mp.tunnel_id, len(mp.ip_dst)) == (1, 66, 16)


@pytest.mark.parametrize("use_native", [True, False], ids=["native",
                                                           "python"])
@pytest.mark.parametrize("name", PCAPS)
def test_read_pcap_equals_reference(name, use_native):
    path = os.path.join(FIXTURE_DIR, f"{name}.pcap")
    got = [_fields(p) for p in packet.read_pcap(path, use_native=use_native)]
    assert got == [_fields(p) for p in ref_packet.read_pcap(path)]
    assert got
    assert packet.read_pcap_records(path) == \
        ref_packet.read_pcap_records(path)


def test_read_pcap_refuses_what_the_reference_refuses(tmp_path):
    short = tmp_path / "short.pcap"
    short.write_bytes(b"\xd4\xc3\xb2\xa1")
    bad = tmp_path / "bad.pcap"
    bad.write_bytes(b"\x00" * 24)
    for path in (short, bad):
        with pytest.raises(ValueError, match="not a pcap file"):
            packet.read_pcap(str(path))
        with pytest.raises(ValueError, match="not a pcap file"):
            ref_packet.read_pcap(str(path))


def test_frame_builders_equal_reference():
    flags = packet.TcpFlags.SYN | packet.TcpFlags.ACK
    assert packet.encode_tcp_frame("10.0.0.1", "10.0.0.2", 1, 2, flags,
                                   b"abc", seq=5, ack=6, window=7) == \
        ref_packet.encode_tcp_frame("10.0.0.1", "10.0.0.2", 1, 2, flags,
                                    b"abc", seq=5, ack=6, window=7)
    assert packet.encode_udp_frame("10.0.0.1", "10.0.0.2", 53, 9, b"q") == \
        ref_packet.encode_udp_frame("10.0.0.1", "10.0.0.2", 53, 9, b"q")
    assert _fields(packet.build_tcp("1.2.3.4", "5.6.7.8", 1, 2, flags,
                                    b"x", 3, 4, 99)) == \
        _fields(ref_packet.build_tcp("1.2.3.4", "5.6.7.8", 1, 2, flags,
                                     b"x", 3, 4, 99))
    assert _fields(packet.build_udp("1.2.3.4", "5.6.7.8", 1, 2, b"y", 9)) \
        == _fields(ref_packet.build_udp("1.2.3.4", "5.6.7.8", 1, 2, b"y",
                                        9))
