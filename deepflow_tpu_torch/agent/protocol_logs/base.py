"""Parser interface, result record, and the inference registry.

Own copy of ``deepflow_tpu/agent/protocol_logs/base.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from deepflow_tpu_torch.proto import wire as pb

MSG_REQUEST = 0
MSG_RESPONSE = 1


@dataclass
class L7ParseResult:
    l7_protocol: int
    msg_type: int                    # MSG_REQUEST | MSG_RESPONSE
    version: str = ""
    request_type: str = ""           # method / command
    request_domain: str = ""         # host / db
    request_resource: str = ""       # path / table / key / topic
    endpoint: str = ""
    request_id: int = 0              # protocol-level correlation id
    response_code: int = 0
    response_status: int = 0         # schema RESPONSE_STATUS index
    response_exception: str = ""
    response_result: str = ""
    trace_id: str = ""
    span_id: str = ""
    x_request_id: str = ""
    captured_byte: int = 0
    session_less: bool = False  # fire-and-forget: no response expected
    attrs: dict = field(default_factory=dict)


class L7Parser:
    PROTOCOL: int = pb.L7_UNKNOWN
    NAME: str = "unknown"

    def check(self, payload: bytes, port_dst: int = 0) -> bool:
        """Cheap magic-byte inference on a request-direction payload."""
        raise NotImplementedError

    def parse(self, payload: bytes,
              is_request: bool = True) -> list[L7ParseResult]:
        """Parse one captured payload into zero or more records."""
        raise NotImplementedError


def status_from_code(code: int, server_error_min: int = 500,
                     client_error_min: int = 400) -> int:
    # RESPONSE_STATUS: 0 unknown, 1 ok, 2 client_error, 3 server_error, 4 timeout
    if code >= server_error_min:
        return 3
    if code >= client_error_min:
        return 2
    return 1


REGISTRY: list[L7Parser] = []


def register(parser_cls):
    REGISTRY.append(parser_cls())
    return parser_cls


def infer_and_parse(payload: bytes, port_dst: int = 0
                    ) -> tuple[int, list[L7ParseResult]]:
    """Try parsers in registry order. Returns (protocol, records)."""
    for parser in REGISTRY:
        try:
            if parser.check(payload, port_dst):
                return parser.PROTOCOL, parser.parse(payload)
        except Exception:
            continue
    return pb.L7_UNKNOWN, []


def get_parser(protocol: int) -> L7Parser | None:
    for p in REGISTRY:
        if p.PROTOCOL == protocol:
            return p
    return None


# importing the modules populates the registry, in priority order
from deepflow_tpu_torch.agent.protocol_logs import http  # noqa: E402,F401
# ping before dns: its port==0 gate is unambiguous (ICMP only), while the
# DNS header sanity check can collide with ICMP echo layouts
from deepflow_tpu_torch.agent.protocol_logs import ping  # noqa: E402,F401
from deepflow_tpu_torch.agent.protocol_logs import dns  # noqa: E402,F401
from deepflow_tpu_torch.agent.protocol_logs import redis  # noqa: E402,F401
from deepflow_tpu_torch.agent.protocol_logs import sqldb  # noqa: E402,F401
from deepflow_tpu_torch.agent.protocol_logs import nosql  # noqa: E402,F401
from deepflow_tpu_torch.agent.protocol_logs import mq  # noqa: E402,F401
from deepflow_tpu_torch.agent.protocol_logs import messaging  # noqa: E402,F401
from deepflow_tpu_torch.agent.protocol_logs import rpc  # noqa: E402,F401
from deepflow_tpu_torch.agent.protocol_logs import rpc2  # noqa: E402,F401
from deepflow_tpu_torch.agent.protocol_logs import enterprise  # noqa: E402,F401
from deepflow_tpu_torch.agent.protocol_logs import tls  # noqa: E402,F401
