"""DNS parser (reference analog: protocol_logs/dns.rs).

Own copy of ``deepflow_tpu/agent/protocol_logs/dns.py``.
"""

from __future__ import annotations

import struct

from deepflow_tpu_torch.proto import wire as pb
from deepflow_tpu_torch.agent.protocol_logs.base import (
    L7Parser, L7ParseResult, MSG_REQUEST, MSG_RESPONSE, register)

_QTYPES = {1: "A", 2: "NS", 5: "CNAME", 6: "SOA", 12: "PTR", 15: "MX",
           16: "TXT", 28: "AAAA", 33: "SRV", 65: "HTTPS", 255: "ANY"}
_RCODES = {0: "NOERROR", 1: "FORMERR", 2: "SERVFAIL", 3: "NXDOMAIN",
           4: "NOTIMP", 5: "REFUSED"}


def _read_name(data: bytes, off: int, depth: int = 0) -> tuple[str, int]:
    labels = []
    while off < len(data):
        ln = data[off]
        if ln == 0:
            off += 1
            break
        if ln & 0xC0 == 0xC0:  # compression pointer
            if depth > 5 or off + 1 >= len(data):
                break
            ptr = ((ln & 0x3F) << 8) | data[off + 1]
            tail, _ = _read_name(data, ptr, depth + 1)
            labels.append(tail)
            off += 2
            return ".".join(x for x in labels if x), off
        off += 1
        labels.append(data[off:off + ln].decode("latin1", "replace"))
        off += ln
    return ".".join(x for x in labels if x), off


@register
class DnsParser(L7Parser):
    PROTOCOL = pb.DNS
    NAME = "dns"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        if len(payload) < 12:
            return False
        if port_dst == 53:
            return True
        flags = struct.unpack_from(">H", payload, 2)[0]
        qd = struct.unpack_from(">H", payload, 4)[0]
        opcode = (flags >> 11) & 0xF
        z = (flags >> 4) & 0x7
        if not (1 <= qd < 16 and opcode in (0, 1, 2) and z == 0):
            return False
        # off-port: the header heuristic alone misfires on binary protocols
        # (fastcgi, icmp) — also require a well-formed non-empty qname with
        # hostname-ish labels and a known qtype
        name, off = _read_name(payload, 12)
        if not name or off + 4 > len(payload):
            return False
        qtype = struct.unpack_from(">H", payload, off)[0]
        if qtype not in _QTYPES:
            return False
        return all(c.isalnum() or c in "-_." for c in name)

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        txid, flags, qd, an, _ns, _ar = struct.unpack_from(">HHHHHH",
                                                           payload, 0)
        is_response = bool(flags & 0x8000)
        rcode = flags & 0xF
        name, off = _read_name(payload, 12)
        qtype = 0
        if off + 4 <= len(payload):
            qtype = struct.unpack_from(">H", payload, off)[0]
        res = L7ParseResult(
            l7_protocol=self.PROTOCOL,
            msg_type=MSG_RESPONSE if is_response else MSG_REQUEST,
            request_type=_QTYPES.get(qtype, str(qtype)),
            request_resource=name,
            request_domain=name,
            endpoint=name,
            request_id=txid,
            captured_byte=len(payload))
        if is_response:
            res.response_code = rcode
            res.response_status = 1 if rcode == 0 else (
                3 if rcode == 2 else 2)
            res.response_exception = "" if rcode == 0 else _RCODES.get(
                rcode, str(rcode))
            answers = []
            if an and off + 4 <= len(payload):
                a_off = off + 4
                for _ in range(min(an, 8)):
                    _nm, a_off = _read_name(payload, a_off)
                    if a_off + 10 > len(payload):
                        break
                    atype, _cls, _ttl, rdlen = struct.unpack_from(
                        ">HHIH", payload, a_off)
                    a_off += 10
                    rdata = payload[a_off:a_off + rdlen]
                    a_off += rdlen
                    if atype == 1 and rdlen == 4:
                        answers.append(".".join(str(b) for b in rdata))
                    elif atype == 28 and rdlen == 16:
                        import ipaddress
                        answers.append(str(ipaddress.ip_address(rdata)))
                    elif atype == 5:
                        cname, _ = _read_name(payload, a_off - rdlen)
                        answers.append(cname)
            res.response_result = ";".join(answers)
        return [res]
