"""The port's native library: the span and metric-document decoders and
string dictionary of ``dfnative.cpp`` and ``ingest.cpp``, the flow-log
decoders of ``pbcols.cpp``, the query kernels of ``qexec.cpp``, and the
packet decode and flow map of ``dfnative.cpp`` and ``flowmap.cpp``,
built at first use and bound with ctypes.

Own copy of the parts of ``deepflow_tpu/native/__init__.py`` that the
server's ingest path uses (``NativeDict``, ``ArenaStrings``,
``SpanColumnDecoder``, ``L4ColumnDecoder``, ``L7ColumnDecoder``,
``DocColumnDecoder``), of the query kernels' bindings (``qx_group``,
``qx_agg_f64``, ``qx_sel_range``, ``qx_sel_isin``, ``qx_gather``,
``qx_isin_u32``), of the flow path's (``decode_eth_batch``, the
``df_fm_*`` flow map and the ``df_ring_*`` TPACKET_V3 ring, with the
packed record dtypes ``PACKET_DTYPE``, ``FLOW_RECORD_DTYPE``,
``L7_EVENT_DTYPE`` and ``SLOW_EVENT_DTYPE``), and of its build.
``load()`` compiles the
sources with ``g++ -O3 -std=c++17 -fPIC -shared`` into ``_build/`` beside
them, the first time a process needs the library. The library's name
carries a hash of its sources and flags, so a stale one is never
loaded; it is compiled to a temporary name and moved into place under
an ``fcntl`` lock, so processes that start at once build it once; and
its ABI version is checked after loading. A failed build or load
raises with the compiler's output: no caller runs without it. Delete
``_build/`` to force a rebuild. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
SOURCES = ("dfnative.cpp", "ingest.cpp", "qexec.cpp", "flowmap.cpp",
           "pbcols.cpp")
HEADERS = ("dfpacket.h", "dfwire.h")
CXX = "g++"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
ABI_VERSION = 4  # must match df_abi_version() in dfnative.cpp

_U64P = ctypes.POINTER(ctypes.c_uint64)
_lib = None
_load_lock = threading.Lock()


class NativeLibraryError(RuntimeError):
    """The native library did not build or load."""


def library_path() -> str:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256(" ".join((CXX,) + CXXFLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libdfnative-{h.hexdigest()[:16]}.so")


def build() -> str:
    """The library's path, compiled first unless it is there already."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # another process built it meanwhile
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [CXX, *CXXFLAGS, *(os.path.join(_DIR, s) for s in SOURCES),
               "-o", tmp]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeLibraryError(f"{' '.join(cmd)}: {e}") from e
        if out.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise NativeLibraryError(
                f"{' '.join(cmd)} exited {out.returncode}:\n{out.stderr}")
        os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The library, built and loaded once per process."""
    global _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        path = build()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise NativeLibraryError(f"cannot load {path}: {e}") from e
        lib.df_abi_version.restype = ctypes.c_int32
        got = lib.df_abi_version()
        if got != ABI_VERSION:
            raise NativeLibraryError(
                f"{path} has ABI {got}, the bindings expect {ABI_VERSION}")
        try:
            _bind(lib)
        except AttributeError as e:  # a symbol the bindings need is gone
            raise NativeLibraryError(f"{path}: {e}") from e
        _lib = lib
        return lib


def _bind(lib: ctypes.CDLL) -> None:
    """Signatures of the library's functions."""
    vp, u32 = ctypes.c_void_p, ctypes.c_uint32
    lib.df_dict_new.restype = vp
    lib.df_dict_free.argtypes = [vp]
    lib.df_dict_len.argtypes = [vp]
    lib.df_dict_len.restype = ctypes.c_uint64
    lib.df_dict_encode_batch.argtypes = [vp, ctypes.c_char_p, vp, u32,
                                         vp]
    lib.df_dict_encode_arena.argtypes = [vp, vp, vp, vp, u32, vp]
    lib.df_dict_encode_arena.restype = ctypes.c_uint64
    lib.df_dict_lookup.argtypes = [vp, ctypes.c_char_p, u32]
    lib.df_dict_lookup.restype = u32
    lib.df_dict_get.argtypes = [vp, u32, ctypes.c_char_p, u32]
    lib.df_dict_get.restype = ctypes.c_int32
    lib.df_dict_load.argtypes = [vp, ctypes.c_char_p, vp, u32]
    lib.df_decode_span_cols.argtypes = [vp, ctypes.c_uint64, vp]
    lib.df_decode_span_cols.restype = ctypes.c_int64
    lib.df_span_batch_counts.argtypes = [vp, ctypes.c_uint64, _U64P,
                                         _U64P]
    lib.df_span_batch_counts.restype = ctypes.c_int32
    u64, nd = ctypes.c_uint64, np.ctypeslib.ndpointer
    lib.df_qx_group.restype = ctypes.c_int64
    lib.df_qx_group.argtypes = [ctypes.POINTER(vp), u32, u64,
                                nd(np.uint64), nd(np.uint64)]
    lib.df_qx_isin_u32.argtypes = [nd(np.uint32), u64, nd(np.uint32),
                                   u64, nd(np.uint8)]
    lib.df_qx_agg_f64.argtypes = [nd(np.float64), nd(np.uint64),
                                  nd(np.uint64), u64, ctypes.c_int32,
                                  nd(np.float64)]
    lib.df_qx_sel_cmp.restype = ctypes.c_int64
    lib.df_qx_sel_cmp.argtypes = [vp, u32, u32, u64, u64, u64,
                                  nd(np.uint64)]
    lib.df_qx_sel_isin_u32.restype = ctypes.c_int64
    lib.df_qx_sel_isin_u32.argtypes = [nd(np.uint32), u64,
                                       nd(np.uint32), u64, nd(np.uint64)]
    lib.df_qx_gather.restype = ctypes.c_int32
    lib.df_qx_gather.argtypes = [vp, u32, nd(np.uint64), u64, vp]
    for name in ("df_decode_l7_cols", "df_decode_doc_cols"):
        getattr(lib, name).argtypes = [vp, ctypes.c_uint64, vp]
        getattr(lib, name).restype = ctypes.c_int64
    lib.df_decode_l4_cols.argtypes = [vp, ctypes.c_uint64, vp, vp, vp,
                                      u32, ctypes.POINTER(u32)]
    lib.df_decode_l4_cols.restype = ctypes.c_int64
    lib.df_flow_batch_counts.argtypes = [vp, ctypes.c_uint64, _U64P,
                                         _U64P]
    lib.df_flow_batch_counts.restype = ctypes.c_int32
    lib.df_doc_batch_count.argtypes = [vp, ctypes.c_uint64, _U64P]
    lib.df_doc_batch_count.restype = ctypes.c_int32
    _bind_flow(lib)


def _bind_flow(lib: ctypes.CDLL) -> None:
    """Signatures of the packet decode, the flow map and the ring."""
    vp, u8, u16, u32, u64 = (ctypes.c_void_p, ctypes.c_uint8,
                             ctypes.c_uint16, ctypes.c_uint32,
                             ctypes.c_uint64)
    i32, nd, u32p = ctypes.c_int32, np.ctypeslib.ndpointer, \
        ctypes.POINTER(ctypes.c_uint32)
    lib.df_decode_eth.argtypes = [ctypes.c_char_p, u32, vp]
    lib.df_decode_eth.restype = i32
    lib.df_decode_eth_batch.argtypes = [ctypes.c_char_p, nd(np.uint32), u32,
                                        vp, nd(np.uint8)]
    lib.df_fm_new.restype = vp
    lib.df_fm_new.argtypes = [u32]
    lib.df_fm_free.argtypes = [vp]
    lib.df_fm_inject_batch.restype = u64
    lib.df_fm_inject_batch.argtypes = [
        vp, ctypes.c_char_p, nd(np.uint32), nd(np.uint64), u32,
        vp, u32,            # l7 payload buffer
        vp, u32, u32p,      # l7 events, their count
        nd(np.uint32), u32, u32p]  # slow-path frame indices, their count
    lib.df_fm_set_l7.argtypes = [vp, u32, u32, u16, u16, u8, u8, u32, i32]
    lib.df_fm_tick.argtypes = [vp, u64]
    lib.df_fm_poll_closed.restype = u32
    lib.df_fm_poll_closed.argtypes = [vp, vp, u32]
    lib.df_fm_export_active.restype = u32
    lib.df_fm_export_active.argtypes = [vp, vp, u32]
    lib.df_fm_flush_all.argtypes = [vp]
    lib.df_fm_active_count.restype = u32
    lib.df_fm_active_count.argtypes = [vp]
    lib.df_fm_closed_count.restype = u32
    lib.df_fm_closed_count.argtypes = [vp]
    lib.df_fm_stats.argtypes = [vp, nd(np.uint64)]
    lib.df_fm_exclude_port.argtypes = [vp, u16, i32]
    lib.df_ring_open.restype = vp
    lib.df_ring_open.argtypes = [ctypes.c_char_p, u32, u32,
                                 ctypes.POINTER(i32)]
    lib.df_ring_close.argtypes = [vp]
    lib.df_ring_rx_batch.restype = ctypes.c_int64
    lib.df_ring_rx_batch.argtypes = [
        vp, vp, i32,
        vp, u32,            # l7 payload buffer
        vp, u32, u32p,      # l7 events, their count
        u32, i32,           # max blocks, skip outgoing copies
        vp, u32,            # slow-path frame buffer
        vp, u32, u32p]      # slow-path events, their count
    lib.df_ring_drops.restype = u64
    lib.df_ring_drops.argtypes = [vp]
    lib.df_ring_promisc.restype = i32
    lib.df_ring_promisc.argtypes = [vp, ctypes.c_char_p, i32]


# must match #pragma pack(1) struct FlowRecord in flowmap.cpp
FLOW_RECORD_DTYPE = np.dtype([
    ("flow_id", np.uint64),
    ("ip_src", np.uint32), ("ip_dst", np.uint32),
    ("port_src", np.uint16), ("port_dst", np.uint16),
    ("protocol", np.uint8), ("state", np.uint8),
    ("close_type", np.uint8), ("closed", np.uint8),
    ("start_ns", np.uint64), ("end_ns", np.uint64),
    ("tx_packets", np.uint64), ("rx_packets", np.uint64),
    ("tx_bytes", np.uint64), ("rx_bytes", np.uint64),
    ("tx_retrans", np.uint32), ("rx_retrans", np.uint32),
    ("tx_zero_window", np.uint32), ("rx_zero_window", np.uint32),
    ("tx_flags_bits", np.uint8), ("rx_flags_bits", np.uint8),
    ("syn_count", np.uint16), ("synack_count", np.uint16),
    ("rtt_us", np.uint32),
    ("tunnel_type", np.uint8), ("tunnel_id", np.uint32)])

# must match #pragma pack(1) struct SlowEvent in flowmap.cpp
SLOW_EVENT_DTYPE = np.dtype([
    ("ts_ns", np.uint64), ("off", np.uint32), ("len", np.uint32)])

# must match #pragma pack(1) struct L7Event in flowmap.cpp
L7_EVENT_DTYPE = np.dtype([
    ("flow_id", np.uint64), ("ts_ns", np.uint64),
    ("payload_off", np.uint32), ("payload_len", np.uint32),
    ("is_tx", np.uint8), ("protocol", np.uint8),
    ("ip_src", np.uint32), ("ip_dst", np.uint32),
    ("port_src", np.uint16), ("port_dst", np.uint16),
    ("tunnel_type", np.uint8), ("tunnel_id", np.uint32)])

# must match struct DfPacketOut in dfpacket.h (natural alignment)
PACKET_DTYPE = np.dtype([
    ("ip_src", np.uint32), ("ip_dst", np.uint32),
    ("port_src", np.uint16), ("port_dst", np.uint16),
    ("protocol", np.uint8), ("tcp_flags", np.uint8),
    ("window", np.uint16), ("seq", np.uint32), ("ack", np.uint32),
    ("payload_off", np.uint32), ("payload_len", np.uint32),
    ("tunnel_type", np.uint8), ("_pad", np.uint8, (3,)),
    ("tunnel_id", np.uint32)], align=True)


def decode_eth_batch(frames: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Ethernet frames decoded natively: (records of PACKET_DTYPE, a bool
    array that is True where the IPv4 fast path decoded the frame)."""
    lib = load()
    n = len(frames)
    offsets = np.zeros(n + 1, dtype=np.uint32)
    np.cumsum([len(f) for f in frames], out=offsets[1:])
    outs = np.zeros(n, dtype=PACKET_DTYPE)
    ok = np.zeros(n, dtype=np.uint8)
    lib.df_decode_eth_batch(b"".join(frames), offsets, n,
                            outs.ctypes.data_as(ctypes.c_void_p), ok)
    return outs, ok.astype(bool)


def _packed(values: list[bytes]) -> tuple[bytes, np.ndarray]:
    """Strings joined, with the n + 1 offsets that bound them."""
    offsets = np.zeros(len(values) + 1, dtype=np.uint32)
    if values:
        offsets[1:] = np.cumsum([len(b) for b in values])
    return b"".join(values), offsets


class NativeDict:
    """A C++ string dictionary (dfnative.cpp DfDict): id 0 is "", new
    strings take the next id. Strings cross as UTF-8 bytes. Not
    thread-safe: the owner serialises calls."""

    def __init__(self) -> None:
        self._lib = load()
        self._h = self._lib.df_dict_new()

    def __del__(self) -> None:
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.df_dict_free(h)

    def __len__(self) -> int:
        return self._lib.df_dict_len(self._h)

    def encode_many(self, values: list[bytes]) -> np.ndarray:
        data, offsets = _packed(values)
        out = np.empty(len(values), dtype=np.uint32)
        self._lib.df_dict_encode_batch(self._h, data, offsets.ctypes.data,
                                       len(values), out.ctypes.data)
        return out

    def encode_arena(self, arena: np.ndarray, offs: np.ndarray,
                     lens: np.ndarray, out: np.ndarray) -> int:
        """Ids of the (off, len) cells of a byte arena into out; returns
        the dictionary's length after them."""
        n = len(offs)
        if not (len(lens) == len(out) == n and offs.dtype == lens.dtype
                == out.dtype == np.uint32 and arena.dtype == np.uint8
                and all(a.flags.c_contiguous
                        for a in (arena, offs, lens, out))):
            raise ValueError("encode_arena takes contiguous uint32 "
                             "offs/lens/out of one length over a uint8 "
                             "arena")
        if n and int((offs.astype(np.uint64) + lens).max()) > len(arena):
            raise ValueError("a cell lies outside the arena")
        return int(self._lib.df_dict_encode_arena(
            self._h, arena.ctypes.data, offs.ctypes.data, lens.ctypes.data,
            n, out.ctypes.data))

    def lookup(self, value: bytes) -> int | None:
        r = self._lib.df_dict_lookup(self._h, value, len(value))
        return None if r == 0xFFFFFFFF else int(r)

    def get(self, sid: int) -> bytes:
        """Entry sid's bytes; IndexError past the end."""
        buf = ctypes.create_string_buffer(256)
        n = self._lib.df_dict_get(self._h, sid, buf, len(buf))
        if n < 0:
            raise IndexError(sid)
        if n > len(buf):
            buf = ctypes.create_string_buffer(n)
            self._lib.df_dict_get(self._h, sid, buf, n)
        return buf.raw[:n]

    def load_entries(self, values: list[bytes]) -> None:
        """Intern values in order (those already present keep their id)."""
        data, offsets = _packed(values)
        self._lib.df_dict_load(self._h, data, offsets.ctypes.data,
                               len(values))


class ArenaStrings:
    """A string column not yet made into Python strings: (off, len) cells
    of a byte arena, straight out of ``SpanColumnDecoder``. The store
    interns it natively (``Dictionary.encode_arena``).

    Unlike the reference's, it does not copy: it views the decoder's
    reused buffers and is valid until that decoder's next ``decode``. The
    store encodes it during the append, so the rows it writes own their
    data."""

    __slots__ = ("arena", "off", "lens")

    def __init__(self, arena: np.ndarray, off: np.ndarray,
                 lens: np.ndarray) -> None:
        self.arena, self.off, self.lens = arena, off, lens

    def __len__(self) -> int:
        return len(self.off)

    def tolist(self) -> list[str]:
        """The cells as Python strings (each distinct value decoded once;
        the decoders admit valid UTF-8 only)."""
        ab = self.arena.tobytes()
        memo: dict[bytes, str] = {}
        out = []
        for o, ln in zip(self.off.tolist(), self.lens.tolist()):
            b = ab[o:o + ln]
            s = memo.get(b)
            if s is None:
                s = memo[b] = b.decode("utf-8")
            out.append(s)
        return out


# -- columnar TpuSpanBatch decode (must mirror DfSpanCols in ingest.cpp) ----

# span string-column slot order; must match span_str_slot() in ingest.cpp
SPAN_STRS = ("hlo_module", "hlo_op", "hlo_category", "collective",
             "process_name")


class _DfSpanCols(ctypes.Structure):
    _pack_ = 1
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "start_ns", "duration_ns", "flops", "bytes_accessed",
            "bytes_transferred", "step",
            "device_id", "chip_id", "core_id", "slice_id", "kind",
            "program_id", "run_id", "replica_group_size", "pid")]
        + [("str_off", ctypes.c_void_p * len(SPAN_STRS)),
           ("str_len", ctypes.c_void_p * len(SPAN_STRS))]
        + [(n, ctypes.c_void_p) for n in (
            "m_timestamp_ns", "m_bytes_in_use", "m_peak_bytes_in_use",
            "m_bytes_limit", "m_largest_free_block",
            "m_device_id", "m_num_allocs", "m_pid",
            "m_pname_off", "m_pname_len", "arena")]
        + [("arena_cap", ctypes.c_uint32),
           ("arena_used", ctypes.c_uint32),
           ("cap", ctypes.c_uint32),
           ("mem_cap", ctypes.c_uint32),
           ("n_mem", ctypes.c_uint32)])


_MALFORMED, _OVERFLOW = -1, -2
_MAX_PAYLOAD = (1 << 32) - 1  # offsets into the arena are uint32


class SpanColumnDecoder:
    """Reusable buffers for df_decode_span_cols: TpuSpanBatch bytes ->
    numpy column views for spans and memory samples (m_* columns).

    ``decode()`` returns (n_spans, cols, n_mem, arena), views into the
    buffers that the next call reuses, or None for a batch the pure
    decoder would refuse too. The arena grows to the payload's size
    before the call (a string cell is a substring of the payload), and a
    batch with more rows than the buffers hold makes them grow to its
    count and decodes again: a well-formed batch always decodes here.
    One decoder per thread."""

    U64 = ("start_ns", "duration_ns", "flops", "bytes_accessed",
           "bytes_transferred", "step")
    U32 = ("device_id", "chip_id", "core_id", "slice_id", "kind",
           "program_id", "run_id", "replica_group_size", "pid")
    M_U64 = ("m_timestamp_ns", "m_bytes_in_use", "m_peak_bytes_in_use",
             "m_bytes_limit", "m_largest_free_block")
    M_U32 = ("m_device_id", "m_num_allocs", "m_pid",
             "m_pname_off", "m_pname_len")

    def __init__(self, cap: int = 4096, mem_cap: int = 256,
                 arena_cap: int = 1 << 20) -> None:
        self._lib = load()
        self._cols = _DfSpanCols()
        self._alloc(cap, mem_cap, arena_cap)

    def _alloc(self, cap: int, mem_cap: int, arena_cap: int) -> None:
        self.arrays: dict[str, np.ndarray] = {}
        for names, dt, rows in ((self.U64, np.uint64, cap),
                                (self.U32, np.uint32, cap),
                                (self.M_U64, np.uint64, mem_cap),
                                (self.M_U32, np.uint32, mem_cap)):
            for n in names:
                self.arrays[n] = np.zeros(rows, dtype=dt)
                setattr(self._cols, n, self.arrays[n].ctypes.data)
        for i, s in enumerate(SPAN_STRS):
            for part, field in (("off", self._cols.str_off),
                                ("len", self._cols.str_len)):
                a = self.arrays[f"{s}_{part}"] = np.zeros(cap, np.uint32)
                field[i] = a.ctypes.data
        self.arena = np.zeros(arena_cap, dtype=np.uint8)
        self._cols.arena = self.arena.ctypes.data
        self._cols.arena_cap = arena_cap
        self._cols.cap = cap
        self._cols.mem_cap = mem_cap

    def decode(self, payload):
        a = np.frombuffer(payload, dtype=np.uint8)
        if len(a) > _MAX_PAYLOAD:
            raise ValueError(f"a {len(a)}-byte batch is past 4 GiB")
        if len(a) > self._cols.arena_cap:
            self._alloc(self._cols.cap, self._cols.mem_cap, len(a))
        n = self._lib.df_decode_span_cols(a.ctypes.data, len(a),
                                          ctypes.byref(self._cols))
        if n == _OVERFLOW:
            spans, mem = ctypes.c_uint64(), ctypes.c_uint64()
            if self._lib.df_span_batch_counts(
                    a.ctypes.data, len(a), ctypes.byref(spans),
                    ctypes.byref(mem)) != 0:
                return None
            self._alloc(max(self._cols.cap, 2 * spans.value),
                        max(self._cols.mem_cap, 2 * mem.value),
                        self._cols.arena_cap)
            n = self._lib.df_decode_span_cols(a.ctypes.data, len(a),
                                              ctypes.byref(self._cols))
            if n == _OVERFLOW:
                raise RuntimeError("span batch overflowed buffers sized "
                                   "to its own counts")
        if n == _MALFORMED:
            return None
        n, n_mem = int(n), int(self._cols.n_mem)
        cols = {k: v[:n_mem] if k.startswith("m_") else v[:n]
                for k, v in self.arrays.items()}
        return n, cols, n_mem, self.arena[:self._cols.arena_used]


# -- columnar FlowLogBatch and DocumentBatch decode (pbcols.cpp and
# ingest.cpp) ---------------------------------------------------------------

# ip_flags bits (must match pbcols.cpp and ingest.cpp)
IP_SRC_EMPTY = 1
IP_DST_EMPTY = 2
IP_FALLBACK = 4

# L7 string-column slot order; must match l7_str_slot() in pbcols.cpp
L7_STRS = ("version", "request_type", "request_domain", "request_resource",
           "endpoint", "response_exception", "response_result", "trace_id",
           "span_id", "parent_span_id", "x_request_id", "process_kname_0",
           "process_kname_1", "attrs_json", "pod_0", "pod_1")


def _cols_struct(name: str, ptrs: tuple[str, ...],
                 strs: int = 0) -> type:
    """A packed ctypes struct of column pointers, then ``strs`` string
    slots' offset and length pointers, the arena and its sizes."""
    fields = [(n, ctypes.c_void_p) for n in ptrs]
    if strs:
        fields += [("str_off", ctypes.c_void_p * strs),
                   ("str_len", ctypes.c_void_p * strs)]
    fields += [("arena", ctypes.c_void_p), ("arena_cap", ctypes.c_uint32),
               ("arena_used", ctypes.c_uint32), ("cap", ctypes.c_uint32)]
    return type(name, (ctypes.Structure,), {"_pack_": 1, "_fields_": fields})


class _ColumnDecoder:
    """Reusable buffers for one columnar decode: ``COLS`` lists (dtype,
    names) in the C struct's order, ``STRS`` the string slots. The
    arena grows to the payload before each call (every cell is a
    substring of it), and a batch with more rows than the buffers hold
    grows them to its counts and decodes again, so a well-formed batch
    always decodes here; ``decode`` returns None only for a batch the
    pure decoder would refuse or decode field by field. The views it
    returns are valid until the next call. One decoder per thread."""

    COLS: tuple = ()
    STRS: tuple = ()
    STRUCT: type

    def __init__(self, cap: int = 4096, arena_cap: int = 1 << 20) -> None:
        self._lib = load()
        self._cols = self.STRUCT()
        self._alloc(cap, arena_cap)

    def _alloc(self, cap: int, arena_cap: int) -> None:
        self.arrays: dict[str, np.ndarray] = {}
        for dt, names in self.COLS:
            for n in names:
                a = self.arrays[n] = np.zeros(cap, dtype=dt)
                setattr(self._cols, n, a.ctypes.data)
        for i, s in enumerate(self.STRS):
            for part, field in (("off", self._cols.str_off),
                                ("len", self._cols.str_len)):
                a = self.arrays[f"{s}_{part}"] = np.zeros(cap, np.uint32)
                field[i] = a.ctypes.data
        self.arena = np.zeros(arena_cap, dtype=np.uint8)
        self._cols.arena = self.arena.ctypes.data
        self._cols.arena_cap = arena_cap
        self._cols.cap = cap
        self._grown(cap)

    def _grown(self, cap: int) -> None:
        """Hook: buffers beside the struct's, of ``cap`` rows."""

    def _call(self, a: np.ndarray) -> int:
        raise NotImplementedError

    def _rows_needed(self, a: np.ndarray) -> int | None:
        raise NotImplementedError

    def _run(self, payload) -> np.ndarray | None:
        """Decode into the buffers; the payload's bytes, or None when
        the batch is malformed."""
        a = np.frombuffer(payload, dtype=np.uint8)
        if len(a) > _MAX_PAYLOAD:
            raise ValueError(f"a {len(a)}-byte batch is past 4 GiB")
        if len(a) > self._cols.arena_cap:
            self._alloc(self._cols.cap, len(a))
        n = self._call(a)
        if n == _OVERFLOW:
            need = self._rows_needed(a)
            if need is None:
                return None
            self._alloc(max(self._cols.cap, 2 * need),
                        self._cols.arena_cap)
            n = self._call(a)
            if n == _OVERFLOW:
                raise RuntimeError(f"{type(self).__name__}: a batch "
                                   "overflowed buffers sized to its counts")
        if n == _MALFORMED:
            return None
        self.n = int(n)
        return a

    def _views(self) -> dict[str, np.ndarray]:
        return {k: v[:self.n] for k, v in self.arrays.items()}


_L4_COLS = (
    (np.uint64, ("flow_id", "start_time_ns", "end_time_ns", "packet_tx",
                 "packet_rx", "byte_tx", "byte_rx", "l7_request",
                 "l7_response")),
    (np.uint32, ("rtt_us", "art_us", "retrans_tx", "retrans_rx",
                 "zero_win_tx", "zero_win_rx")),
    (np.uint8, ("close_type",)),
    (np.uint32, ("syn_count", "synack_count", "gpid_0", "gpid_1",
                 "ip4_src", "ip4_dst")),
    (np.uint8, ("is_v6",)),
    (np.uint32, ("ip6_src_off", "ip6_dst_off")),
    (np.uint8, ("ip_flags",)),
    (np.uint16, ("port_src", "port_dst")),
    (np.uint8, ("proto",)),
    (np.uint32, ("tap_port",)),
    (np.uint8, ("tunnel_type",)),
    (np.uint32, ("tunnel_id", "pod0_off", "pod0_len", "pod1_off",
                 "pod1_len")))

_L7_COLS = (
    (np.uint64, ("flow_id", "start_time_ns", "end_time_ns",
                 "syscall_trace_id_request", "syscall_trace_id_response",
                 "captured_request_byte", "captured_response_byte")),
    (np.uint32, ("l7_protocol", "request_id", "response_status")),
    (np.int32, ("response_code",)),
    (np.uint32, ("syscall_thread_0", "syscall_thread_1", "gpid_0",
                 "gpid_1", "ip4_src", "ip4_dst")),
    (np.uint8, ("is_v6",)),
    (np.uint32, ("ip6_src_off", "ip6_dst_off")),
    (np.uint8, ("ip_flags",)),
    (np.uint16, ("port_src", "port_dst")),
    (np.uint8, ("proto", "tunnel_type")),
    (np.uint32, ("tunnel_id",)))

_DOC_COLS = (
    (np.uint64, ("timestamp_s", "packet_tx", "packet_rx", "byte_tx",
                 "byte_rx", "flow_count", "new_flow", "closed_flow",
                 "rtt_sum", "rtt_count", "retrans", "syn_count",
                 "synack_count", "request", "response", "rrt_sum",
                 "rrt_count", "rrt_max", "error_client", "error_server",
                 "timeout")),
    (np.uint32, ("ip4_src", "ip4_dst", "proto", "l7_protocol",
                 "app_service_off", "app_service_len", "port",
                 "direction")),
    (np.uint8, ("has_flow", "has_app", "ip_flags")))


def _names(cols: tuple) -> tuple[str, ...]:
    return tuple(n for _, names in cols for n in names)


class L4ColumnDecoder(_ColumnDecoder):
    """df_decode_l4_cols: the L4 rows of a FlowLogBatch as numpy column
    views. ``decode()`` returns (n_l4, cols, n_l7, arena) or None for a
    malformed batch; n_l7 counts the L7 entries, left for
    ``L7ColumnDecoder``."""

    COLS = _L4_COLS
    STRUCT = _cols_struct("_DfL4Cols", _names(_L4_COLS))

    def _grown(self, cap: int) -> None:
        self._l7_off = np.zeros(cap, dtype=np.uint32)
        self._l7_len = np.zeros(cap, dtype=np.uint32)
        self._n_l7 = ctypes.c_uint32(0)

    def _call(self, a: np.ndarray) -> int:
        return self._lib.df_decode_l4_cols(
            a.ctypes.data, len(a), ctypes.byref(self._cols),
            self._l7_off.ctypes.data, self._l7_len.ctypes.data,
            len(self._l7_off), ctypes.byref(self._n_l7))

    def _rows_needed(self, a: np.ndarray) -> int | None:
        n4, n7 = ctypes.c_uint64(), ctypes.c_uint64()
        if self._lib.df_flow_batch_counts(a.ctypes.data, len(a),
                                          ctypes.byref(n4),
                                          ctypes.byref(n7)) != 0:
            return None
        return max(n4.value, n7.value)

    def decode(self, payload):
        if self._run(payload) is None:
            return None
        return self.n, self._views(), int(self._n_l7.value), \
            self.arena[:self._cols.arena_used]


class L7ColumnDecoder(_ColumnDecoder):
    """df_decode_l7_cols: the L7 rows of a FlowLogBatch, their sixteen
    string columns as arena (off, len) cells. ``decode()`` returns
    (n_l7, cols, arena) or None for a malformed batch."""

    COLS = _L7_COLS
    STRS = L7_STRS
    STRUCT = _cols_struct("_DfL7Cols", _names(_L7_COLS), len(L7_STRS))

    def _call(self, a: np.ndarray) -> int:
        return self._lib.df_decode_l7_cols(a.ctypes.data, len(a),
                                           ctypes.byref(self._cols))

    def _rows_needed(self, a: np.ndarray) -> int | None:
        n4, n7 = ctypes.c_uint64(), ctypes.c_uint64()
        if self._lib.df_flow_batch_counts(a.ctypes.data, len(a),
                                          ctypes.byref(n4),
                                          ctypes.byref(n7)) != 0:
            return None
        return n7.value

    def decode(self, payload):
        if self._run(payload) is None:
            return None
        return self.n, self._views(), self.arena[:self._cols.arena_used]


class DocColumnDecoder(_ColumnDecoder):
    """df_decode_doc_cols: a DocumentBatch as numpy column views, the
    meters' fields under their flow_metrics column names, HasField as
    ``has_flow`` / ``has_app`` and empty or non-v4 addresses in
    ``ip_flags``. ``decode()`` returns (n, cols, arena) or None for a
    malformed batch."""

    COLS = _DOC_COLS
    STRUCT = _cols_struct("_DfDocCols", _names(_DOC_COLS))

    def _call(self, a: np.ndarray) -> int:
        return self._lib.df_decode_doc_cols(a.ctypes.data, len(a),
                                            ctypes.byref(self._cols))

    def _rows_needed(self, a: np.ndarray) -> int | None:
        n = ctypes.c_uint64()
        if self._lib.df_doc_batch_count(a.ctypes.data, len(a),
                                        ctypes.byref(n)) != 0:
            return None
        return n.value

    def decode(self, payload):
        if self._run(payload) is None:
            return None
        return self.n, self._views(), self.arena[:self._cols.arena_used]


# -- encoded query execution kernels (qexec.cpp) ----------------------------
#
# Each takes numpy arrays and returns numpy arrays; the library builds at
# the first call. The engine's numpy paths compute the same answers, and
# its cost models choose between the two per call (query/engine.py).

def qx_group(key_cols: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray,
                                                   int]:
    """Hash-group rows over key columns (cast to int64) in one O(n) pass:
    (order, bounds, n_groups), rows ``order[bounds[g]:bounds[g+1]]``
    forming group g, groups in FIRST-OCCURRENCE order, rows within a
    group in their original order."""
    lib = load()
    if not key_cols:
        raise ValueError("qx_group needs at least one key column")
    n = len(key_cols[0])
    order = np.empty(n, dtype=np.uint64)
    bounds = np.empty(n + 1, dtype=np.uint64)
    cast = [np.ascontiguousarray(k, dtype=np.int64) for k in key_cols]
    if any(len(k) != n for k in cast):
        raise ValueError("qx_group key columns differ in length")
    ptrs = (ctypes.c_void_p * len(cast))(*[k.ctypes.data for k in cast])
    ng = lib.df_qx_group(ptrs, len(cast), n, order, bounds)
    if ng < 0:
        raise ValueError("df_qx_group refused its arguments")
    return order.astype(np.int64), bounds[:ng + 1].astype(np.int64), int(ng)


def _u64_view(a: np.ndarray) -> np.ndarray:
    if a.dtype == np.int64 and a.flags.c_contiguous:
        return a.view(np.uint64)
    return np.ascontiguousarray(a, dtype=np.uint64)


def qx_agg_f64(vals: np.ndarray, order: np.ndarray, bounds: np.ndarray,
               op: int) -> np.ndarray:
    """Fused gather + segmented reduce: out[g] = op over
    vals[order[i]] for i in [bounds[g], bounds[g+1]); op 0 sum, 1 min,
    2 max. Accumulates in row order within each group, as ufunc.reduceat
    over the gathered array does, so the two give the same bits."""
    lib = load()
    n_groups = len(bounds) - 1
    if n_groups < 0 or op not in (0, 1, 2):
        raise ValueError("qx_agg_f64 needs n_groups + 1 bounds and op 0-2")
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    order64, bounds64 = _u64_view(order), _u64_view(bounds)
    if n_groups and (int(bounds64.max()) > len(order64)
                     or (len(order64) and int(order64.max()) >= len(vals))):
        raise ValueError("qx_agg_f64 bounds or order out of range")
    out = np.empty(n_groups, dtype=np.float64)
    lib.df_qx_agg_f64(vals, order64, bounds64, n_groups, op, out)
    return out


def qx_sel_range(col: np.ndarray, lo, hi) -> np.ndarray:
    """Ascending uint64 positions of the rows with lo <= col[i] <= hi
    (both inclusive, both representable in col's integer dtype)."""
    lib = load()
    if col.dtype.kind not in "iu" or col.itemsize not in (1, 2, 4, 8):
        raise ValueError(f"qx_sel_range over a {col.dtype} column")
    col = np.ascontiguousarray(col)
    udt = np.dtype(f"u{col.itemsize}")
    lo_bits = int(np.asarray(lo, dtype=col.dtype).view(udt))
    hi_bits = int(np.asarray(hi, dtype=col.dtype).view(udt))
    out = np.empty(len(col), dtype=np.uint64)
    m = lib.df_qx_sel_cmp(col.ctypes.data, col.itemsize,
                          1 if col.dtype.kind == "i" else 0, len(col),
                          lo_bits, hi_bits, out)
    return out[:m]


def qx_sel_isin(col: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Ascending uint64 positions of the rows whose id is in ids (a
    native hash set): the dictionary-id IN / LIKE filter as positions."""
    lib = load()
    col = np.ascontiguousarray(col, dtype=np.uint32)
    ids = np.ascontiguousarray(ids, dtype=np.uint32)
    out = np.empty(len(col), dtype=np.uint64)
    m = lib.df_qx_sel_isin_u32(col, len(col), ids, len(ids), out)
    return out[:m]


def qx_gather(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """out[j] = src[idx[j]] for a 1/2/4/8-byte dtype."""
    lib = load()
    if src.itemsize not in (1, 2, 4, 8) or src.dtype.hasobject:
        raise ValueError(f"qx_gather over a {src.dtype} column")
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, dtype=np.uint64)
    if len(idx) and int(idx.max()) >= len(src):
        raise IndexError("qx_gather index out of range")
    out = np.empty(len(idx), dtype=src.dtype)
    lib.df_qx_gather(src.ctypes.data, src.itemsize, idx, len(idx),
                     out.ctypes.data)
    return out


def qx_isin_u32(col: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Bool mask of col[i] in ids through a native hash set (O(n), where
    np.isin sorts): the encoded-predicate filter of the mask path."""
    lib = load()
    col = np.ascontiguousarray(col, dtype=np.uint32)
    ids = np.ascontiguousarray(ids, dtype=np.uint32)
    mask = np.empty(len(col), dtype=np.uint8)
    lib.df_qx_isin_u32(col, len(col), ids, len(ids), mask)
    return mask.astype(bool)
