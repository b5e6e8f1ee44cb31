"""The port's YAML reader and AgentConfig held against the reference.

``agent/yamlcfg.py`` must read what ``yaml.safe_load`` reads, on the
repo's own YAML (the agent template, the controller's default config,
the Kubernetes manifest's documents and the agent config its ConfigMap
carries), on a corpus of YAML 1.1's surprises, and on configs that
hypothesis generates and ``yaml.safe_dump`` writes; outside its subset
it raises with a line number. ``AgentConfig.from_dict`` and ``validate``
must give the reference's fields and verdicts on the same mappings,
``AgentConfig.load`` reads a file, and the node agent's ``-f`` takes it.
"""

import dataclasses
import math
import os
import subprocess
import sys

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from deepflow_tpu.agent import config as ref_config
from deepflow_tpu.server.controller import \
    DEFAULT_AGENT_CONFIG_YAML as REF_DEFAULT_YAML
from deepflow_tpu_torch.agent import config as port_config
from deepflow_tpu_torch.agent import yamlcfg
from deepflow_tpu_torch.server.controller import DEFAULT_AGENT_CONFIG_YAML

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b) -> bool:
    """Equal values of equal types, NaN equal to NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    return a == b


def _both(text):
    """(safe_load's value or its error type, the reader's)."""
    try:
        want = ("ok", yaml.safe_load(text))
    except yaml.YAMLError as e:
        want = ("error", type(e).__name__)
    try:
        got = ("ok", yamlcfg.load(text))
    except yamlcfg.YamlError as e:
        got = ("error", str(e))
    return want, got


# -- the reader against safe_load -----------------------------------------------

CORPUS = [
    "", "# only a comment\n", "---\na: 1\n", "a: 1\n...\n",
    # YAML 1.1 resolution
    "a: yes\nb: No\nc: ON\nd: off\ne: True\nf: FALSE\n",
    "a: y\nb: n\nc: Yes!\n",
    "a: ~\nb: null\nc: NULL\nd:\ne: Null\n",
    "a: 1e3\nb: 1.0e+3\nc: 1.0e3\nd: .5\ne: -.inf\nf: .NaN\ng: 1_000.5\n",
    "a: 0x_1F\nb: 0b1010\nc: 012\nd: 09\ne: 0o17\nf: -0\ng: +12\n",
    "a: 190:20:30\nb: 1:2:3.5\nc: 1:70\n",
    "a: 3.\nb: -3.\nc: 1_000\nd: 0_7\n",
    # structure
    "a:\n- 1\n- 2\nb: x\n", "a:\n  - 1\n  -\n  - 3\n",
    "- a: 1\n  b: 2\n- - x\n  - y\n- [z]\n",
    "a:\n  b:\n    c: [1, {d: 2, e: [3]}]\n  f: {}\ng: []\n",
    "servers: [[\"127.0.0.1\", 20033], ['10.0.0.1', 20033]]\n",
    "a: {x: 1,\n    y: [2,\n        3], }\n", "{a, b: , c: d}",
    "[a b, 'c d', \"e\"]", "{a:1}", "[a:1]", "{'a':1, \"b\":2}",
    "1: one\n~: none\ntrue: yes\n2.5: x\n",
    "a: 1\na: 2\n",
    "  a: 1\n  b: 2\n",
    # scalars
    "a: b # comment\nc: d#e\n", "a:   x   y  \n", "a: b\n  c\n\n  d\n",
    "a: 'x''y'\nb: 'long\n  folded\n\n  para'\n",
    "a: \"tab\\there \\u00e9 \\x41 \\U0001F600 \\\\ \\\" \\/ \\N \\_\"\n",
    "a: \"x \\\n   y\"\nb: \"p\n\n  q\"\n",
    "a: :x\nb: -x\nc: ?x\nd: a:b\ne: http://x/y?z=1#f\n",
    "a: ''\nb: \"\"\nc: ' lead'\nd: 'trail '\n",
    "key with spaces: v\n'quoted key': w\n\"dq\": z\n",
    # explicit keys, as safe_dump writes empty and long ones
    "? ''\n: null\na:\n  ? ''\n  : [1]\n", "{? '' : null, a: {? '' : 1}}",
    "- ? ''\n  : 1\n", "? a b\n  c d\n: 1\n? lone\nz: 2\n",
    # errors on both sides
    "a: -\n", "a: x:\n", "a: b\nc\n", "a: 1\n---\nb: 2\n", "a: [1, 2\n",
    "a: 'open\n", "a:\n  b: 1\n c: 2\n", "- a\nb: 1\n", "a: 'x'y\n",
]

OUTSIDE_SUBSET = [
    ("a: &x 1\nb: *x\n", "anchors"), ("a: !!str 1\n", "tags"),
    ("a: |\n  x\n", "block scalars"), ("a: >\n  x\n", "block scalars"),
    ("? [a]\n: b\n", "collections as keys"), ("[a]: b\n", "collections"),
    ("<<: {a: 1}\n", "merge key"),
    ("a: 2001-12-14\n", "dates"), ("%YAML 1.1\n---\na: 1\n", "directives"),
    ("[a: 1]\n", "single-pair"), ("a:\n\t- 1\n", "tab"),
    ("a: =\n", "'='"),
]


@pytest.mark.parametrize("text", CORPUS)
def test_reader_equals_safe_load(text):
    want, got = _both(text)
    assert want[0] == got[0], (text, want, got)
    if want[0] == "ok":
        assert _same(want[1], got[1]), (text, want, got)
    else:
        assert got[1].startswith("line "), got


@pytest.mark.parametrize("text,what", OUTSIDE_SUBSET)
def test_reader_refuses_what_it_does_not_cover(text, what):
    with pytest.raises(yamlcfg.YamlError, match=r"^line \d+: .*" + what):
        yamlcfg.load(text)


def _manifest_docs():
    with open(os.path.join(ROOT, "manifests", "deepflow-tpu.yaml")) as f:
        return f.read().split("\n---\n")


def test_reader_on_the_repos_yaml():
    """The agent template, the controller's default config (both
    packages'), each manifest document (the one with a block scalar
    refused), and the agent config its ConfigMap carries."""
    with open(os.path.join(ROOT, "docs", "agent-template.yaml")) as f:
        template = f.read()
    texts = [template, DEFAULT_AGENT_CONFIG_YAML, REF_DEFAULT_YAML]
    assert DEFAULT_AGENT_CONFIG_YAML == REF_DEFAULT_YAML
    refused = 0
    docs = _manifest_docs()
    assert len(docs) >= 5
    for doc in docs:
        want, got = _both(doc)
        if got[0] == "error":
            assert "block scalars" in got[1]
            refused += 1
            embedded = want[1]["data"]["agent.yaml"]
            texts.append(embedded)
        else:
            texts.append(doc)
    assert refused == 1
    for text in texts:
        want, got = _both(text)
        assert want[0] == got[0] == "ok" and _same(want[1], got[1]), text


_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-(1 << 70), max_value=1 << 70)
            | st.floats(allow_nan=True, allow_infinity=True)
            | st.text(max_size=40))
_keys = st.text(max_size=12) | st.integers(-1000, 1000)
_values = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=4)
                   | st.dictionaries(_keys, inner, max_size=4)),
    max_leaves=12)


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.dictionaries(_keys, _values, max_size=6),
       flow=st.sampled_from([False, None, True]),
       width=st.integers(min_value=10, max_value=200),
       allow_unicode=st.booleans(), sort_keys=st.booleans())
def test_reader_equals_safe_load_on_dumped_configs(
        data, flow, width, allow_unicode, sort_keys):
    text = yaml.safe_dump(data, default_flow_style=flow, width=width,
                          allow_unicode=allow_unicode, sort_keys=sort_keys)
    want, got = _both(text)
    assert want[0] == "ok"
    assert got[0] == "ok" and _same(want[1], got[1]), (text, want, got)


@settings(max_examples=200, deadline=None)
@given(cfg=st.fixed_dictionaries({}, optional={
    "profiler": st.fixed_dictionaries({}, optional={
        "enabled": st.booleans(),
        "sample_hz": st.floats(0.05, 20_000) | st.integers(0, 20_000),
        "emit_interval_s": st.floats(0.001, 10)}),
    "tpuprobe": st.fixed_dictionaries({}, optional={
        "trace_interval_s": st.floats(0.01, 100),
        "trace_duration_ms": st.integers(0, 5000),
        "target_coverage": st.floats(0.0, 1.0),
        "steps_per_capture": st.integers(0, 20_000)}),
    "guard": st.fixed_dictionaries({}, optional={
        "max_cpu_pct": st.floats(0, 200), "max_mem_mb": st.floats(0, 4096),
        "check_interval_s": st.floats(0.01, 60)}),
    "stats_interval_s": st.floats(0.01, 60),
    "group": st.text(max_size=8),
}))
def test_dumped_agent_configs_give_the_references_config(cfg):
    """YAML a config tool writes, read both ways, gives the reference's
    fields and the reference's verdict."""
    text = yaml.safe_dump(cfg)
    port = port_config.AgentConfig.from_dict(yamlcfg.load(text))
    ref = ref_config.AgentConfig.from_dict(yaml.safe_load(text))
    for section in ("profiler", "tpuprobe", "guard"):
        p, r = dataclasses.asdict(getattr(port, section)), \
            dataclasses.asdict(getattr(ref, section))
        assert {k: p[k] for k in p if k in r} == \
            {k: r[k] for k in p if k in r}
    assert (port.stats_interval_s, port.group) == \
        (ref.stats_interval_s, ref.group)
    verdicts = []
    for c in (port, ref):
        try:
            c.validate()
            verdicts.append(None)
        except ValueError as e:
            verdicts.append(str(e))
    assert verdicts[0] == verdicts[1]


# -- AgentConfig ----------------------------------------------------------------

SHARED = {
    "profiler": {"enabled": False, "sample_hz": 250.0,
                 "emit_interval_s": 0.5, "memory": True,
                 "memory_interval_s": 5.0},
    "tpuprobe": {"enabled": True, "source": "auto", "trace_interval_s": 2.5,
                 "trace_duration_ms": 500, "target_coverage": 0.25,
                 "steps_per_capture": 5, "memory_poll_s": 0.0,
                 "step_metrics": False, "step_topk": 3},
    "guard": {"enabled": False, "max_cpu_pct": 25.0, "max_mem_mb": 512.0,
              "check_interval_s": 1.0},
    "flow": {"enabled": True, "interface": "lo", "capture_mode": "mirror"},
    "sender": {"servers": [["10.0.0.1", 20033], "10.0.0.2:7"],
               "queue_size": 64, "spool": {"enabled": True, "max_mb": 8}},
    "chaos": {"enabled": True, "seed": 7, "conn_reset": 0.1},
    "selfmon": {"deadman_window_s": 3.0},
    "qos": {"hz_scale": [1.0, 0.6, 0.3, 0.1]},
    "acls": [{"cidr": "10.0.0.0/8", "port": 80, "action": "ignore"}],
    "agent_id": 7, "app_service": "svc", "group": "prod",
    "controller": "10.0.0.9:20035", "stats_interval_s": 5.0,
    "sync_interval_s": 2.0, "not_a_field": 1,
}


def test_from_dict_gives_the_references_fields():
    port = port_config.AgentConfig.from_dict(SHARED).validate()
    ref = ref_config.AgentConfig.from_dict(SHARED).validate()
    p, r = dataclasses.asdict(port), dataclasses.asdict(ref)
    shared = [k for k in p if k in r]
    assert len(shared) >= 15
    for k in shared:
        if isinstance(p[k], dict):
            assert {f: v for f, v in p[k].items() if f in r[k]} == \
                {f: r[k][f] for f in p[k] if f in r[k]}, k
        else:
            assert p[k] == r[k], k
    assert port.sender.servers == [("10.0.0.1", 20033), ("10.0.0.2", 7)]


@pytest.mark.parametrize("bad", [
    {"profiler": {"sample_hz": "fast"}}, {"profiler": {"sample_hz": 0.01}},
    {"tpuprobe": {"target_coverage": 0.99}},
    {"guard": {"max_mem_mb": 1}}, {"stats_interval_s": 0},
    {"sync_interval_s": 0.01}, {"qos": {"emit_scale": [1.0]}},
    {"qos": {"enabled": "yes"}}, {"acls": ["10.0.0.0/8"]},
    {"acls": [{"action": "drop"}]}, {"acls": [{"cidr": "10.0.0.0/33"}]},
    {"acls": [{"port": 70000}]},
    {"profiler": {"memory_interval_s": 0.5}},
    {"sender": {"spool": {"max_mb": 1, "segment_mb": 4}}},
])
def test_validate_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError):
        ref_config.AgentConfig.from_dict(bad).validate()
    with pytest.raises(ValueError):
        port_config.AgentConfig.from_dict(bad).validate()


def test_unknown_section_key_raises_as_the_reference():
    for mod in (ref_config, port_config):
        with pytest.raises(TypeError):
            mod.AgentConfig.from_dict({"guard": {"max_cpu": 10}})


def test_port_source_is_kineto():
    """The port's probe has one source: the reference's JAX sources'
    names are refused, not silently taken."""
    port_config.AgentConfig.from_dict(
        {"tpuprobe": {"source": "kineto"}}).validate()
    with pytest.raises(ValueError, match="auto|kineto"):
        port_config.AgentConfig.from_dict(
            {"tpuprobe": {"source": "xplane"}}).validate()


def test_load_reads_a_file(tmp_path):
    path = tmp_path / "agent.yaml"
    path.write_text(yaml.safe_dump({k: v for k, v in SHARED.items()
                                    if k != "not_a_field"}))
    got = port_config.AgentConfig.load(str(path)).validate()
    assert got.profiler.sample_hz == 250.0
    assert got.controller == "10.0.0.9:20035" and got.group == "prod"
    assert port_config.AgentConfig.load(None) == port_config.AgentConfig()
    empty = tmp_path / "empty.yaml"
    empty.write_text("# nothing\n")
    assert port_config.AgentConfig.load(str(empty)) == \
        port_config.AgentConfig()
    with pytest.raises(FileNotFoundError):
        port_config.AgentConfig.load(str(tmp_path / "missing.yaml"))
    listed = tmp_path / "list.yaml"
    listed.write_text("- a\n")
    with pytest.raises(ValueError, match="mapping"):
        port_config.AgentConfig.load(str(listed))
    bad = tmp_path / "bad.yaml"
    bad.write_text("profiler:\n  sample_hz: &a 1\n")
    with pytest.raises(yamlcfg.YamlError, match="line 2"):
        port_config.AgentConfig.load(str(bad))


def test_node_agent_takes_its_config_file(tmp_path):
    """python -m deepflow_tpu_torch.agent -f FILE: the file's flow block
    starts capture; an unreadable file ends it non-zero, naming it."""
    path = tmp_path / "agent.yaml"
    path.write_text("flow:\n  enabled: true\n  interface: nope0\n"
                    "profiler:\n  enabled: false\ntpuprobe:\n"
                    "  enabled: false\n")
    code = ("import sys\n"
            "from deepflow_tpu_torch.agent import agent\n"
            "from deepflow_tpu_torch.agent.config import AgentConfig\n"
            f"cfg = AgentConfig.load({str(path)!r})\n"
            "print(cfg.flow.enabled, cfg.flow.interface,"
            " cfg.profiler.enabled)\n"
            "agent.main(['-f', sys.argv[1], '--server', '127.0.0.1:9',"
            " '--device', 'cpu'])\n")
    out = subprocess.run([sys.executable, "-c", code, str(path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.splitlines()[0] == "True nope0 False"
    # the flow block took effect: capture on nope0 cannot open
    assert out.returncode != 0
    assert "nope0" in out.stderr
    out = subprocess.run(
        [sys.executable, "-m", "deepflow_tpu_torch.agent", "-f",
         str(tmp_path / "missing.yaml"), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and "missing.yaml" in out.stderr
