"""The golden capture corpus through the port's dispatcher: every
``tests/fixtures/pcaps/*.pcap`` replayed on ``engine="python"`` and on
``engine="native"`` gives its pinned ``.result`` (the JAX package's
``tests/test_golden_corpus.py`` checks, read from the same files), and
the L4 and L7 rows of the JAX package's dispatcher on the same engine,
field for field (byte for byte on the wire). The fixtures are read and
never written."""

import json
import os

import pytest

from deepflow_tpu.agent.dispatcher import Dispatcher as RefDispatcher
from deepflow_tpu.agent.protocol_logs import base as ref_base
from deepflow_tpu_torch.agent.dispatcher import Dispatcher
from deepflow_tpu_torch.agent.protocol_logs import base
from deepflow_tpu_torch.codec import MessageType
from deepflow_tpu_torch.proto import wire
from test_golden_corpus import _check

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "pcaps")
CASES = sorted(fn[:-5] for fn in os.listdir(FIXTURE_DIR)
               if fn.endswith(".pcap"))


def _replay(cls, name: str, engine: str) -> dict:
    """The wire rows of one replay, by message type."""
    rows = {MessageType.L4_LOG: [], MessageType.L7_LOG: []}

    class Collector:
        def send(self, mt, payload):
            if mt in rows:
                b = wire.FlowLogBatch.FromString(payload)
                rows[mt] += [m.SerializeToString()
                             for m in (b.l4 or b.l7)]
            return True

    disp = cls(sender=Collector(), engine=engine)
    disp.replay_pcap(os.path.join(FIXTURE_DIR, f"{name}.pcap"))
    return rows


def test_corpus_covers_every_parser():
    assert len(CASES) == 29
    covered = set()
    for name in CASES:
        with open(os.path.join(FIXTURE_DIR, f"{name}.result")) as f:
            covered.add(json.load(f)["l7_protocol"])
    parsed = {int(p) for p in wire.L7Protocol
              if p and base.get_parser(p) is not None}
    assert parsed == {int(p) for p in wire.L7Protocol
                      if p and ref_base.get_parser(p) is not None}
    assert parsed <= covered
    # the registry's order is the inference order
    assert [type(p).__name__ for p in base.REGISTRY] == \
        [type(p).__name__ for p in ref_base.REGISTRY]


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("name", CASES)
def test_golden_capture(name, engine):
    with open(os.path.join(FIXTURE_DIR, f"{name}.result")) as f:
        expect = json.load(f)
    got = _replay(Dispatcher, name, engine)
    l7 = [wire.L7FlowLog.FromString(b) for b in got[MessageType.L7_LOG]]
    _check(l7, expect)
    want = _replay(RefDispatcher, name, engine)
    assert got == want
    assert got[MessageType.L4_LOG]


def _payloads() -> list[tuple[bytes, int]]:
    """(payload, server port) of every TCP/UDP packet of every capture,
    each also cut at a seeded point and with seeded bytes flipped."""
    import numpy as np

    from deepflow_tpu_torch.agent.packet import read_pcap
    rng = np.random.default_rng(10)
    out = []
    for name in CASES:
        for p in read_pcap(os.path.join(FIXTURE_DIR, f"{name}.pcap"),
                           use_native=False):
            if not p.payload:
                continue
            port = min(p.port_src, p.port_dst)
            out.append((p.payload, port))
            out.append((p.payload[:int(rng.integers(len(p.payload)))],
                        port))
            b = bytearray(p.payload)
            for i in rng.integers(0, len(b), 3):
                b[i] = int(rng.integers(0, 256))
            out.append((bytes(b), port))
    return out


def _outcome(fn, *args):
    import dataclasses
    try:
        got = fn(*args)
    except Exception as e:  # both packages must fail alike
        return ("raised", type(e).__name__)
    if isinstance(got, list):
        return [dataclasses.asdict(r) for r in got]
    if isinstance(got, tuple):
        return (got[0], [dataclasses.asdict(r) for r in got[1]])
    return got


@pytest.mark.parametrize("index", range(len(base.REGISTRY)))
def test_parser_equals_reference(index):
    """Each parser of the registry against the reference's, on every
    payload of the corpus, cut and flipped: check, parse in both
    directions, and the registry's inference."""
    mine, theirs = base.REGISTRY[index], ref_base.REGISTRY[index]
    assert type(mine).__name__ == type(theirs).__name__
    assert (mine.PROTOCOL, mine.NAME) == (theirs.PROTOCOL, theirs.NAME)
    for payload, port in _payloads():
        assert _outcome(mine.check, payload, port) == \
            _outcome(theirs.check, payload, port)
        for is_request in (True, False):
            assert _outcome(mine.parse, payload, is_request) == \
                _outcome(theirs.parse, payload, is_request)
    if index == 0:
        for payload, port in _payloads():
            assert _outcome(base.infer_and_parse, payload, port) == \
                _outcome(ref_base.infer_and_parse, payload, port)
