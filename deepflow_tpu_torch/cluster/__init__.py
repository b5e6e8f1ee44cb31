"""Cluster federation: N port servers answering as one querier.

Own copy of ``deepflow_tpu/cluster/`` (the reference's multi-ingester
DeepFlow deployment, where the querier fans a query out over every
shard and merges): membership gossip (``membership.py``), the framed
columnar result wire (``wire.py``), the retry and hedge remote client
(``remote.py``), the consistent-hash replication ring and its
query-time claim filter (``hashring.py``), shard-dictionary sync for
encoded partials (``dictsync.py``) and the scatter-gather coordinator
(``federation.py``, the read tier's handshake included), and the
cluster-wide partial-aggregate cache of the querier replicas
(``partialcache.py``). ``Percentile`` merges through
``query/sketch.py``, the reference's ``cluster/sketch.py``.
"""

from deepflow_tpu_torch.cluster.membership import (ClusterMembership, Peer,
                                                   PeerDirectory)
from deepflow_tpu_torch.cluster.remote import (FanOut, ShardCallError,
                                               ShardClient)
from deepflow_tpu_torch.cluster.wire import decode_result, encode_result

__all__ = [
    "ClusterMembership", "Peer", "PeerDirectory",
    "FanOut", "ShardCallError", "ShardClient",
    "encode_result", "decode_result",
]
