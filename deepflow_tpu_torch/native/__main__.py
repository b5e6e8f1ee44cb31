"""Which native paths of the port are live.

    python -m deepflow_tpu_torch.native --selfcheck
    python -m deepflow_tpu_torch.native --verify-abi

Own copy of ``deepflow_tpu/native/__main__.py``. It builds (or loads)
the library as the server does, then runs each native path on a small
input and says which answered. The port has no kill switch and no
fallback for a path: a path that is not live is an error, and both
commands exit 1 on one (``--verify-abi`` prints only the verdict). A
failed build, load or ABI check raises as ``native.load()`` does and
exits 1 with its message.
"""

from __future__ import annotations

import sys

import numpy as np


def _probes(native) -> list[tuple[str, object]]:
    """(name, probe) for every native path; a probe returns truthy when
    the path answered as it should."""
    from deepflow_tpu_torch.store.dictionary import Dictionary

    def dict_arena():
        ids = Dictionary("selfcheck").encode_arena(
            np.frombuffer(b"ab", dtype=np.uint8),
            np.array([0, 0], dtype=np.uint32),
            np.array([2, 0], dtype=np.uint32))
        return ids.tolist() == [1, 0]

    def flow_map():
        fm = native.load().df_fm_new(16)
        native.load().df_fm_free(fm)
        return bool(fm)

    return [
        ("L4 flow-log columnar decode",
         lambda: native.L4ColumnDecoder(cap=16).decode(b"") is not None),
        ("L7 flow-log columnar decode",
         lambda: native.L7ColumnDecoder(cap=16).decode(b"") is not None),
        ("metrics doc columnar decode",
         lambda: native.DocColumnDecoder(cap=16).decode(b"") is not None),
        ("tpu-span columnar decode",
         lambda: native.SpanColumnDecoder(cap=16, mem_cap=16).decode(b"")
         is not None),
        ("dictionary arena encode", dict_arena),
        ("ethernet/IPv4 batch decode",
         lambda: len(native.decode_eth_batch([b"\x00" * 60])[1]) == 1),
        ("query kernels",
         lambda: native.qx_group([np.array([3, 1, 3])])[2] == 2),
        ("native FlowMap", flow_map),
    ]


def _run() -> tuple[object, list[tuple[str, bool, str]]]:
    from deepflow_tpu_torch import native
    lib = native.load()
    out = []
    for name, probe in _probes(native):
        try:
            out.append((name, bool(probe()), ""))
        except Exception as e:  # a path that raised is not live
            out.append((name, False, f"{type(e).__name__}: {e}"))
    return lib, out


def selfcheck() -> int:
    from deepflow_tpu_torch import native
    print("deepflow-tpu (port) native selfcheck")
    print(f"  library             : {native.library_path()}")
    lib, paths = _run()
    print(f"  ABI                 : {lib.df_abi_version()} "
          f"(bindings {native.ABI_VERSION})")
    for name, ok, why in paths:
        print(f"  {name:<28}: {'live' if ok else 'NOT LIVE ' + why}")
    live = sum(ok for _, ok, _ in paths)
    print(f"  native paths live   : {live}/{len(paths)}")
    return 0 if live == len(paths) else 1


def verify_abi() -> int:
    from deepflow_tpu_torch import native
    lib, paths = _run()
    bad = [name for name, ok, _ in paths if not ok]
    if bad:
        print("verify-abi: FAIL: not live: " + ", ".join(bad))
        return 1
    print(f"verify-abi: OK: ABI {lib.df_abi_version()}, all "
          f"{len(paths)} native paths live")
    return 0


def main(argv: list[str]) -> int:
    from deepflow_tpu_torch.native import NativeLibraryError
    try:
        if "--verify-abi" in argv:
            return verify_abi()
        if "--selfcheck" in argv or not argv:
            return selfcheck()
    except NativeLibraryError as e:
        print(f"native library: {e}", file=sys.stderr)
        return 1
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
