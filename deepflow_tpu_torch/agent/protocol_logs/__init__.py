"""L7 protocol inference + parsing.

Reference analog: agent/src/flow_generator/protocol_logs/ (the ~30-protocol
decoder set listed at agent/src/common/l7_protocol_log.rs:163-226) plus the
in-kernel inference of agent/src/ebpf/kernel/include/protocol_inference.h.
Round-1 set: HTTP/1, HTTP/2(+gRPC detect), DNS, Redis, MySQL, PostgreSQL,
Memcached, Kafka, MongoDB. The registry order mirrors the reference's
inference priority (cheap magic checks first).

Own copy of ``deepflow_tpu/agent/protocol_logs/__init__.py``.
"""

from deepflow_tpu_torch.agent.protocol_logs.base import (  # noqa: F401
    L7ParseResult, L7Parser, infer_and_parse, REGISTRY)
