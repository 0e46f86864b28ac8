"""The msgpack subset of CoCLR's LMDB stores, read without the ``msgpack``
package.

A CoCLR store (reference coclr_utils/lmdb_dataset.py:74-81) frames each
value with msgpack: ``__len__`` an int, ``__keys__`` / ``__order__`` arrays
of bytes, each video an array of JPEG bytes. The JAX package reads them
with ``msgpack.loads``; the port always reads them here, so every machine
takes the same path whether or not msgpack is installed (as ``lmdb_lite``
does for LMDB itself).

``loads`` decodes the types those stores hold: positive and negative
fixint, uint 8-64, int 8-64, nil, str (decoded as UTF-8, as
``msgpack.loads`` does by default), bin, array (as a list) and map (as a
dict); any other type code raises ``ValueError``, as do trailing bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

_FIXED = {  # type code -> (struct format, kind)
    0xcc: (">B", "int"), 0xcd: (">H", "int"), 0xce: (">I", "int"),
    0xcf: (">Q", "int"), 0xd0: (">b", "int"), 0xd1: (">h", "int"),
    0xd2: (">i", "int"), 0xd3: (">q", "int"),
    0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
    0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
    0xdc: (">H", "array"), 0xdd: (">I", "array"),
    0xde: (">H", "map"), 0xdf: (">I", "map"),
}


def _read(buf: memoryview, pos: int) -> Tuple[Any, int]:
    code = buf[pos]
    pos += 1
    if code <= 0x7f:
        return code, pos
    if code >= 0xe0:
        return code - 0x100, pos
    if 0xa0 <= code <= 0xbf:
        kind, n = "str", code & 0x1f
    elif 0x90 <= code <= 0x9f:
        kind, n = "array", code & 0x0f
    elif 0x80 <= code <= 0x8f:
        kind, n = "map", code & 0x0f
    elif code == 0xc0:
        return None, pos
    elif code in _FIXED:
        fmt, kind = _FIXED[code]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        if kind == "int":
            return n, pos
    else:
        raise ValueError(f"msgpack type code {code:#04x} at byte {pos - 1} "
                         "is not one a CoCLR store holds")
    if kind in ("str", "bin"):
        if pos + n > len(buf):
            raise ValueError(f"msgpack {kind} of {n} bytes runs past the end")
        raw = bytes(buf[pos:pos + n])
        return (raw.decode("utf-8") if kind == "str" else raw), pos + n
    if kind == "array":
        out = []
        for _ in range(n):
            item, pos = _read(buf, pos)
            out.append(item)
        return out, pos
    out = {}
    for _ in range(n):
        key, pos = _read(buf, pos)
        out[key], pos = _read(buf, pos)
    return out, pos


def loads(data: bytes) -> Any:
    """One msgpack object from ``data`` (all of it)."""
    buf = memoryview(data)
    try:
        obj, pos = _read(buf, 0)
    except (IndexError, struct.error) as e:
        raise ValueError("truncated msgpack data") from e
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} bytes of extra data after the "
                         "msgpack object")
    return obj
