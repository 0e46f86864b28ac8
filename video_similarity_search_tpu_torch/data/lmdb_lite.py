"""Minimal, dependency-free LMDB on-disk format support (read + bulk-write);
the port's own copy of the JAX package's ``data/lmdb_lite.py``.

The reference's CoCLR pipeline reads msgpack frames out of LMDB stores
(coclr_utils/lmdb_dataset.py:74-81). :class:`LMDBReader` (lmdb_data.py)
reads every store through this module, with or without the ``lmdb``
wheel: a pure-Python pager for the LMDB 0.9 on-disk format (the format of files
produced by py-lmdb / liblmdb 0.9.x, data version 1).

Implements exactly what the datasets need:

* :class:`LiteEnv` — read-only ``get(key)`` over a standard LMDB file
  (``data.mdb`` in a directory, or a ``subdir=False`` single file): meta
  page selection by transaction id, B+tree descent over branch/leaf pages,
  overflow (``F_BIGDATA``) values.
* :func:`write_lmdb` — a bulk writer producing a spec-conformant database
  from a ``{bytes: bytes}`` mapping (sorted keys, packed leaves, branch
  levels, overflow pages, twin meta pages). Used to build test fixtures
  with the reference's key scheme without the wheel.

Layout facts encoded below (LMDB 0.9 ``mdb.c``):

  page header (16 B):  pgno u64 | pad u16 | flags u16 | lower u16 | upper u16
                       (overflow pages reuse lower/upper as a u32 page count)
  page flags:          P_BRANCH 0x01, P_LEAF 0x02, P_OVERFLOW 0x04, P_META 0x08
  node (8 B + data):   lo u16 | hi u16 | flags u16 | ksize u16 | key | value
                       leaf:   datasize = lo | hi<<16; F_BIGDATA 0x01 means the
                               value region is a u64 overflow pgno
                       branch: child pgno = lo | hi<<16 | flags<<32
  node ptr array:      u16 offsets (from page start) right after the header;
                       numkeys = (lower - 16) / 2
  meta (at offset 16): magic u32 = 0xBEEFC0DE | version u32 = 1 | address u64 |
                       mapsize u64 | MDB_db[2] | last_pg u64 | txnid u64
  MDB_db (48 B):       pad u32 | flags u16 | depth u16 | branch_pages u64 |
                       leaf_pages u64 | overflow_pages u64 | entries u64 |
                       root u64;  page size lives in dbs[0].pad, root of the
                       main tree in dbs[1].root (P_INVALID = 2**64-1 if empty)
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, Optional, Tuple

MAGIC = 0xBEEFC0DE
DATA_VERSION = 1
PAGE_SIZE = 4096
HDR = 16                      # page header bytes
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
P_INVALID = (1 << 64) - 1

_PGHDR = struct.Struct("<QHHHH")          # pgno, pad, flags, lower, upper
_PGHDR_OVF = struct.Struct("<QHHI")       # pgno, pad, flags, page-count
_NODE = struct.Struct("<HHHH")            # lo, hi, flags, ksize
_DB = struct.Struct("<IHHQQQQQ")          # pad, flags, depth, branch, leaf,
                                          # overflow, entries, root
_META = struct.Struct("<IIQQ")            # magic, version, address, mapsize
# full meta = _META + 2*_DB + last_pg + txnid


def _db_file(path: str) -> str:
    """Directory layout stores the database in ``<dir>/data.mdb``
    (reference opens with ``subdir=os.path.isdir(db_path)``)."""
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class LiteEnv:
    """Read-only LMDB environment: ``get()`` + key iteration.

    Thread-safe: all reads go through ``os.pread`` on one fd (no shared
    seek cursor), so the datasets' thread-pooled ``__getitem__`` calls can
    ``get()`` concurrently — the shared-handle seek+read form interleaved
    under PrefetchLoader's pool and returned wrong pages."""

    def __init__(self, path: str):
        self._fd = os.open(_db_file(path), os.O_RDONLY)

        def read_meta(offset: int, which: int):
            raw = os.pread(self._fd, _META.size + 2 * _DB.size + 16,
                           offset + HDR)
            magic, version, _addr, _mapsize = _META.unpack_from(raw, 0)
            if magic != MAGIC:
                raise ValueError(f"not an LMDB file (meta {which} magic "
                                 f"{magic:#x} != {MAGIC:#x})")
            if version != DATA_VERSION:
                raise ValueError(f"unsupported LMDB data version {version}")
            free_db = _DB.unpack_from(raw, _META.size)
            main_db = _DB.unpack_from(raw, _META.size + _DB.size)
            last_pg, txnid = struct.unpack_from(
                "<QQ", raw, _META.size + 2 * _DB.size)
            return txnid, free_db, main_db, last_pg

        # meta 0 always starts at offset 0; it carries the REAL page size
        # (dbs[0].pad), which locates meta 1 — files written on hosts with
        # a non-4096 OS page size put meta 1 at that stride
        meta0 = read_meta(0, 0)
        psize = meta0[1][0] or PAGE_SIZE
        meta1 = read_meta(psize, 1)
        txnid, free_db, main_db, _ = max((meta0, meta1),
                                         key=lambda m: m[0])
        self.page_size = psize
        self.root = main_db[7]
        self.depth = main_db[2]
        self.entries = main_db[6]

    def close(self) -> None:
        os.close(self._fd)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _page(self, pgno: int) -> bytes:
        return os.pread(self._fd, self.page_size, pgno * self.page_size)

    def _nodes(self, page: bytes) -> Iterator[Tuple[bytes, int, int, int]]:
        """Yield (key, lo|hi<<16, node_flags, value_offset) per node."""
        _, _, flags, lower, _upper = _PGHDR.unpack_from(page, 0)
        n = (lower - HDR) >> 1
        for i in range(n):
            off = struct.unpack_from("<H", page, HDR + 2 * i)[0]
            lo, hi, nflags, ksize = _NODE.unpack_from(page, off)
            key = page[off + 8:off + 8 + ksize]
            yield key, lo | (hi << 16), nflags, off + 8 + ksize

    def _read_value(self, page: bytes, size: int, nflags: int,
                    voff: int) -> bytes:
        if nflags & F_BIGDATA:
            ovf_pgno = struct.unpack_from("<Q", page, voff)[0]
            ovf = self._page(ovf_pgno)
            _, _, pflags, _count = _PGHDR_OVF.unpack_from(ovf, 0)
            if not pflags & P_OVERFLOW:
                raise ValueError(f"page {ovf_pgno}: expected overflow page")
            return os.pread(self._fd, size,
                            ovf_pgno * self.page_size + HDR)
        return page[voff:voff + size]

    def get(self, key: bytes) -> Optional[bytes]:
        if self.root == P_INVALID:
            return None
        pgno = self.root
        for _ in range(64):  # depth bound (defensive; real depth is small)
            page = self._page(pgno)
            _, _, pflags, lower, _ = _PGHDR.unpack_from(page, 0)
            nodes = list(self._nodes(page))
            if pflags & P_LEAF:
                for k, size, nflags, voff in nodes:
                    if k == key:
                        return self._read_value(page, size, nflags, voff)
                return None
            if not pflags & P_BRANCH:
                raise ValueError(f"page {pgno}: unexpected flags {pflags:#x}")
            # branch: last child whose (separator) key <= target; node 0 is
            # the leftmost child with an empty key
            child = None
            for i, (k, lohi, nflags, _voff) in enumerate(nodes):
                if i > 0 and k > key:
                    break
                child = lohi | (nflags << 32)
            if child is None:
                raise ValueError(f"page {pgno}: empty branch page")
            pgno = child
        raise ValueError("B+tree deeper than 64 levels (corrupt file?)")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order scan (fixture verification; not a hot path)."""
        if self.root == P_INVALID:
            return
        stack = [self.root]
        while stack:
            pgno = stack.pop()
            page = self._page(pgno)
            _, _, pflags, _, _ = _PGHDR.unpack_from(page, 0)
            nodes = list(self._nodes(page))
            if pflags & P_LEAF:
                for k, size, nflags, voff in nodes:
                    yield k, self._read_value(page, size, nflags, voff)
            else:
                for k, lohi, nflags, _ in reversed(nodes):
                    stack.append(lohi | (nflags << 32))


# ---------------------------------------------------------------------------
# Bulk writer (fixtures)
# ---------------------------------------------------------------------------

def _node_bytes(lo_hi: int, nflags: int, key: bytes,
                value: bytes = b"") -> bytes:
    raw = _NODE.pack(lo_hi & 0xFFFF, (lo_hi >> 16) & 0xFFFF, nflags,
                     len(key)) + key + value
    return raw + b"\x00" * (len(raw) & 1)  # 2-byte node alignment


def _pack_page(pgno: int, pflags: int, nodes: list) -> bytes:
    """Nodes grow down from the page end; the ptr array up from the header
    (same layout liblmdb produces)."""
    buf = bytearray(PAGE_SIZE)
    upper = PAGE_SIZE
    ptrs = []
    for raw in nodes:
        upper -= len(raw)
        buf[upper:upper + len(raw)] = raw
        ptrs.append(upper)
    lower = HDR + 2 * len(nodes)
    assert lower <= upper, "page overflow"
    _PGHDR.pack_into(buf, 0, pgno, 0, pflags, lower, upper)
    for i, p in enumerate(ptrs):
        struct.pack_into("<H", buf, HDR + 2 * i, p)
    return bytes(buf)


# values bigger than this go to overflow pages (liblmdb: me_nodemax is
# roughly psize/2 minus headers; any threshold <= that produces valid files)
_INLINE_MAX = 1920


def write_lmdb(path: str, mapping: Dict[bytes, bytes],
               subdir: bool = False) -> str:
    """Write ``mapping`` as a spec-conformant LMDB database; returns the
    path usable with ``LiteEnv`` / ``lmdb.open`` (``data.mdb`` inside
    ``path`` when ``subdir``)."""
    if subdir:
        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, "data.mdb")
    else:
        out = path
    items = sorted(mapping.items())
    for k, _ in items:
        if not 0 < len(k) <= 511:
            raise ValueError(f"key length {len(k)} outside LMDB limits")

    pages: Dict[int, bytes] = {}
    next_pg = 2  # 0/1 are meta
    n_overflow = 0

    # --- leaves (greedy fill) --------------------------------------------
    leaves = []                  # (first_key, pgno, staged_nodes)

    def leaf_fits(staged, extra_len):
        used = HDR + 2 * (len(staged) + 1) + sum(
            len(s) for s in staged) + extra_len
        return used <= PAGE_SIZE

    staged: list = []
    staged_first: Optional[bytes] = None

    def flush_leaf():
        nonlocal staged, staged_first, next_pg
        if not staged:
            return
        pgno = next_pg
        next_pg += 1
        leaves.append((staged_first, pgno, staged))
        staged, staged_first = [], None

    # first pass: stage node byte strings; overflow values get a pgno
    # placeholder patched in the second pass (after leaf pages are laid out,
    # overflow pages follow them so pgnos are known only then)
    staged_big: list = []        # (leaf_index, node_index, value)
    for key, value in items:
        if 8 + len(key) + len(value) > _INLINE_MAX:
            raw = _node_bytes(len(value), F_BIGDATA, key, b"\x00" * 8)
            is_big = True
        else:
            raw = _node_bytes(len(value), 0, key, value)
            is_big = False
        if not leaf_fits(staged, len(raw)):
            flush_leaf()
        if staged_first is None:
            staged_first = key
        if is_big:
            staged_big.append((len(leaves), len(staged), value))
        staged.append(raw)
    flush_leaf()

    # --- overflow pages ---------------------------------------------------
    for leaf_idx, node_idx, value in staged_big:
        ovf_pgno = next_pg
        span = -(-(HDR + len(value)) // PAGE_SIZE)
        next_pg += span
        n_overflow += span
        raw = bytearray(span * PAGE_SIZE)
        _PGHDR_OVF.pack_into(raw, 0, ovf_pgno, 0, P_OVERFLOW, span)
        raw[HDR:HDR + len(value)] = value
        pages[ovf_pgno] = bytes(raw)
        # patch the placeholder pgno in the staged node's value region
        node = bytearray(leaves[leaf_idx][2][node_idx])
        _, _, _, ksize = _NODE.unpack_from(node, 0)
        struct.pack_into("<Q", node, 8 + ksize, ovf_pgno)
        leaves[leaf_idx][2][node_idx] = bytes(node)

    for first, pgno, nodes in leaves:
        pages[pgno] = _pack_page(pgno, P_LEAF, nodes)

    # --- branch levels ----------------------------------------------------
    level = [(first, pgno) for first, pgno, _ in leaves]
    depth = 1
    n_branch = 0
    while len(level) > 1:
        nxt = []
        i = 0
        while i < len(level):
            pgno = next_pg
            next_pg += 1
            n_branch += 1
            nodes, firsts = [], []
            used = HDR
            j = i
            while j < len(level):
                key = b"" if j == i else level[j][0]
                raw = _node_bytes(level[j][1] & 0xFFFFFFFF,
                                  (level[j][1] >> 32) & 0xFFFF, key)
                if used + 2 + len(raw) > PAGE_SIZE:
                    break
                nodes.append(raw)
                used += 2 + len(raw)
                j += 1
            pages[pgno] = _pack_page(pgno, P_BRANCH, nodes)
            nxt.append((level[i][0], pgno))
            i = j
        level = nxt
        depth += 1

    root = level[0][1] if level else P_INVALID
    if not items:
        root, depth = P_INVALID, 0

    # --- metas ------------------------------------------------------------
    last_pg = next_pg - 1
    mapsize = max(next_pg * PAGE_SIZE, 1 << 20)

    def meta_page(pgno: int, txnid: int) -> bytes:
        buf = bytearray(PAGE_SIZE)
        _PGHDR.pack_into(buf, 0, pgno, 0, P_META, 0, 0)
        off = HDR
        _META.pack_into(buf, off, MAGIC, DATA_VERSION, 0, mapsize)
        off += _META.size
        # FREE_DBI: page size in pad, MDB_INTEGERKEY flags (0x08, as
        # liblmdb writes for its freelist DB), empty tree
        _DB.pack_into(buf, off, PAGE_SIZE, 0x08, 0, 0, 0, 0, 0, P_INVALID)
        off += _DB.size
        # MAIN_DBI
        _DB.pack_into(buf, off, 0, 0, depth, n_branch, len(leaves),
                      n_overflow, len(items), root)
        off += _DB.size
        struct.pack_into("<QQ", buf, off, last_pg, txnid)
        return bytes(buf)

    with open(out, "wb") as f:
        f.write(meta_page(0, 0))
        f.write(meta_page(1, 1))
        # entries are keyed by their FIRST pgno; a multi-page overflow blob
        # covers its whole span, so writing in pgno order reconstructs a
        # dense file
        written = 2
        for pgno in sorted(pages):
            assert pgno == written, (pgno, written)
            blob = pages[pgno]
            f.write(blob)
            written += len(blob) // PAGE_SIZE
        assert written == next_pg, (written, next_pg)
    return path
