"""Pure-Python implementation of the LMDB on-disk data format (v1).

The port's own copy of ``iisan_tpu/data/lmdbfile.py`` (the port imports
nothing of the JAX package).  The reference stores item images in LMDB
databases built by its ``Dataset/build_lmdb.py`` and read per sample
during uncached training.  Neither this package's test machine nor the
GPU machine has the ``lmdb`` wheel or ``liblmdb``, so ``data/images.py``
reads and writes through this module unless ``import lmdb`` succeeds;
it implements the *actual* LMDB file format:

  * **Reader**: memory-maps a database produced by real liblmdb (file form
    or ``data.mdb`` directory form), picks the live meta page by
    transaction id, and walks the B+tree: branch/leaf node search,
    overflow-page (``F_BIGDATA``) chains, streaming in-order cursors.
  * **Writer**: single-writer bulk builder.  ``commit()`` serializes the
    key-value set as a bottom-up-packed B+tree (leaf/branch pages filled
    the way liblmdb's sequential-insert path does: nodes allocated
    downward from ``mp_upper``, 2-byte-aligned, values larger than the
    node-max spilling to overflow pages) and atomically replaces the file
    (tmp + fsync + rename, directory fsync'd).  For the same key-value set
    it writes the same bytes as the JAX package's writer.

Struct layout follows liblmdb 0.9.x ``mdb.c`` (64-bit, little-endian:
``MDB_page``/``MDB_node``/``MDB_meta``/``MDB_db``); magic ``0xBEEFC0DE``,
data-format version 1.  Scope: the single unnamed database with default
byte-order key comparison, which is what the reference uses.  Dupsort
databases and named sub-databases are out of scope and raise on read.

Durability model of the writer: whole-tree rewrite per commit (suits the
build-once/read-many image-catalog use; not a general transactional KV
store).  Readers stream from mmap and hold nothing in RAM.

API surface mirrors the slice of the ``lmdb`` package this repo uses:
``open`` / ``Environment.begin`` / ``Transaction.{get,put,delete,commit,
abort,cursor}`` / ``Cursor`` iteration+seek / ``Environment.{stat,sync,
close}``.
"""

from __future__ import annotations

import io
import mmap
import os
import struct
import threading
from bisect import bisect_left, bisect_right

# ---------------------------------------------------------------------------
# Format constants (liblmdb 0.9.x, 64-bit little-endian build)
# ---------------------------------------------------------------------------

MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1
PAGEHDRSZ = 16                      # sizeof(MDB_page) header (64-bit)
NODEHDRSZ = 8                       # sizeof(MDB_node) header
P_INVALID = 0xFFFFFFFFFFFFFFFF      # pgno_t ~0: no root
DEFAULT_PSIZE = 4096
MAXKEYSIZE = 511                    # liblmdb default MDB_MAXKEYSIZE

# MDB_page.mp_flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20
P_SUBP = 0x40

# MDB_node.mn_flags (leaf nodes)
F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

# env flags persisted in the meta (mm_flags == mm_dbs[0].md_flags)
MDB_NOSUBDIR = 0x4000
MDB_INTEGERKEY = 0x08               # liblmdb stamps the free-DB integerkey

_PAGEHDR = struct.Struct("<QHHHH")          # pgno, pad, flags, lower, upper
_OVPAGES = struct.Struct("<I")              # pb_pages (union with lower/upper)
_NODEHDR = struct.Struct("<HHHH")           # lo, hi, flags, ksize
_DB = struct.Struct("<IHHQQQQQ")            # pad,flags,depth,branch,leaf,ovfl,entries,root
_META_HEAD = struct.Struct("<IIQQ")         # magic, version, address, mapsize
_META_TAIL = struct.Struct("<QQ")           # last_pg, txnid
_PGNO = struct.Struct("<Q")

LEGACY_SHIM_MAGIC = b"IISAN-LMDB-SHIM-v1\n"


class Error(Exception):
    """Mirror of lmdb.Error."""


def _even(n: int) -> int:
    return (n + 1) & ~1


def _nodemax(psize: int) -> int:
    # mdb.c: me_nodemax = ((psize - PAGEHDRSZ) / MDB_MINKEYS) & -2, MINKEYS=2
    return ((psize - PAGEHDRSZ) // 2) & ~1


def _ovpages(dsize: int, psize: int) -> int:
    # mdb.c OVPAGES(): pages needed for PAGEHDRSZ + dsize bytes
    return (PAGEHDRSZ - 1 + dsize) // psize + 1


# ---------------------------------------------------------------------------
# Reader: B+tree walk over an mmap of a real LMDB database
# ---------------------------------------------------------------------------

class _Meta:
    __slots__ = ("mapsize", "psize", "flags", "main", "last_pg", "txnid")

    def __init__(self, buf, off: int):
        magic, version, _addr, self.mapsize = _META_HEAD.unpack_from(buf, off)
        if magic != MDB_MAGIC:
            raise Error("bad meta magic (not an LMDB data file)")
        if version != MDB_DATA_VERSION:
            raise Error(f"unsupported LMDB data version {version}")
        free = _DB.unpack_from(buf, off + _META_HEAD.size)
        self.main = _DB.unpack_from(buf, off + _META_HEAD.size + _DB.size)
        self.psize = free[0]            # mm_psize lives in mm_dbs[0].md_pad
        self.flags = free[1]
        self.last_pg, self.txnid = _META_TAIL.unpack_from(
            buf, off + _META_HEAD.size + 2 * _DB.size)


class _TreeReader:
    """Streaming read access to the main DB of a mapped LMDB file."""

    def __init__(self, buf):
        self.buf = buf
        meta_sz = _META_HEAD.size + 2 * _DB.size + _META_TAIL.size
        if len(buf) < PAGEHDRSZ + meta_sz:
            raise Error("not an LMDB data file (too small for a meta page)")
        m0 = _Meta(buf, PAGEHDRSZ)          # meta page 0: header then MDB_meta
        self.psize = m0.psize
        if self.psize < 512 or self.psize & (self.psize - 1):
            raise Error(f"implausible LMDB page size {self.psize}")
        meta = m0
        if len(buf) >= 2 * self.psize:
            try:
                m1 = _Meta(buf, self.psize + PAGEHDRSZ)
                if m1.txnid > m0.txnid:
                    meta = m1
            except Error:
                pass                         # torn second meta: use meta 0
        (_, db_flags, self.depth, self.branch_pages, self.leaf_pages,
         self.overflow_pages, self.entries, self.root) = meta.main
        if db_flags & 0x06:                  # MDB_REVERSEKEY | MDB_DUPSORT
            raise Error(f"main DB flags {db_flags:#x}: reversekey/dupsort "
                        "databases are not supported")
        self.meta = meta

    # -- page decoding ------------------------------------------------------
    def _page(self, pgno: int):
        off = pgno * self.psize
        if off + self.psize > len(self.buf):
            raise Error(f"page {pgno} beyond end of file")
        _pg, _pad, flags, lower, upper = _PAGEHDR.unpack_from(self.buf, off)
        return off, flags, lower, upper

    def _nkeys(self, lower: int) -> int:
        return (lower - PAGEHDRSZ) // 2

    def _node_key(self, page_off: int, ptr_idx: int) -> bytes:
        ofs = struct.unpack_from(
            "<H", self.buf, page_off + PAGEHDRSZ + 2 * ptr_idx)[0]
        ksize = struct.unpack_from("<H", self.buf, page_off + ofs + 6)[0]
        ko = page_off + ofs + NODEHDRSZ
        return bytes(self.buf[ko:ko + ksize])

    def _bisect(self, page_off: int, nkeys: int, key: bytes,
                right: bool = False, lo: int = 0) -> int:
        """bisect_left/right over the page's keys, decoding only the
        O(log n) probed keys (get() runs once per image on the uncached
        hot path; materializing every key per page would allocate ~100x
        more)."""
        hi = nkeys
        while lo < hi:
            mid = (lo + hi) // 2
            k = self._node_key(page_off, mid)
            if (k <= key) if right else (k < key):
                lo = mid + 1
            else:
                hi = mid
        return lo

    def _node(self, page_off: int, ptr_idx: int):
        ofs = struct.unpack_from(
            "<H", self.buf, page_off + PAGEHDRSZ + 2 * ptr_idx)[0]
        lo, hi, flags, ksize = _NODEHDR.unpack_from(self.buf, page_off + ofs)
        key_off = page_off + ofs + NODEHDRSZ
        key = bytes(self.buf[key_off:key_off + ksize])
        return lo, hi, flags, key, key_off + ksize

    def _leaf_value(self, lo, hi, flags, data_off) -> bytes:
        dsize = lo | (hi << 16)
        if flags & (F_SUBDATA | F_DUPDATA):
            raise Error("dupsort/named sub-databases are not supported by "
                        "the pure-Python LMDB reader")
        if flags & F_BIGDATA:
            pgno = _PGNO.unpack_from(self.buf, data_off)[0]
            off, pflags, _, _ = self._page(pgno)
            if not pflags & P_OVERFLOW:
                raise Error(f"page {pgno} expected overflow, flags {pflags:#x}")
            npages = _OVPAGES.unpack_from(self.buf, off + 12)[0]
            # bound the WHOLE chain: mmap slicing truncates silently past
            # EOF, which would hand back a short value instead of an error
            if (dsize > npages * self.psize - PAGEHDRSZ
                    or off + npages * self.psize > len(self.buf)):
                raise Error(f"overflow chain at page {pgno} truncated "
                            f"({npages} pages for {dsize} bytes)")
            start = off + PAGEHDRSZ
            return bytes(self.buf[start:start + dsize])
        return bytes(self.buf[data_off:data_off + dsize])

    def _keys(self, page_off: int, lower: int):
        out = []
        for i in range(self._nkeys(lower)):
            ofs = struct.unpack_from(
                "<H", self.buf, page_off + PAGEHDRSZ + 2 * i)[0]
            ksize = struct.unpack_from("<H", self.buf, page_off + ofs + 6)[0]
            ko = page_off + ofs + NODEHDRSZ
            out.append(bytes(self.buf[ko:ko + ksize]))
        return out

    def _branch_child(self, page_off: int, idx: int) -> int:
        lo, hi, flags, _k, _ = self._node(page_off, idx)
        return lo | (hi << 16) | (flags << 32)

    # -- lookups ------------------------------------------------------------
    def get(self, key: bytes):
        if self.root == P_INVALID:
            return None
        pgno = self.root
        for _ in range(64):                  # depth bound; real trees are ~4
            off, flags, lower, upper = self._page(pgno)
            nkeys = self._nkeys(lower)
            if flags & P_BRANCH:
                # child i covers [key_i, key_{i+1}); node 0's key is empty
                i = self._bisect(off, nkeys, key, right=True, lo=1) - 1
                pgno = self._branch_child(off, i)
            elif flags & P_LEAF:
                if flags & P_LEAF2:
                    raise Error("LEAF2 (fixed-size dupsort) pages unsupported")
                i = self._bisect(off, nkeys, key)
                if i >= nkeys:
                    return None
                lo, hi, nflags, k, data_off = self._node(off, i)
                if k != key:
                    return None
                return self._leaf_value(lo, hi, nflags, data_off)
            else:
                raise Error(f"page {pgno} has unexpected flags {flags:#x}")
        raise Error("B+tree deeper than 64 levels (corrupt file?)")

    def iter_from(self, key=None):
        """Yield (key, value) in order, starting at the first key >= `key`
        (or from the start when None)."""
        if self.root == P_INVALID:
            return
        stack = []                           # (page_off, keys, next_idx)
        pgno = self.root
        while True:
            off, flags, lower, upper = self._page(pgno)
            keys = self._keys(off, lower)
            if flags & P_BRANCH:
                i = 0 if key is None else bisect_right(keys, key, lo=1) - 1
                stack.append((off, keys, i + 1, True))
                pgno = self._branch_child(off, i)
            elif flags & P_LEAF:
                i = 0 if key is None else bisect_left(keys, key)
                stack.append((off, keys, i, False))
                break
            else:
                raise Error(f"page {pgno} has unexpected flags {flags:#x}")
        while stack:
            off, keys, i, is_branch = stack.pop()
            if is_branch:
                if i < len(keys):
                    stack.append((off, keys, i + 1, True))
                    pgno = self._branch_child(off, i)
                    # descend leftmost under child i
                    while True:
                        coff, cflags, clower, _ = self._page(pgno)
                        ckeys = self._keys(coff, clower)
                        if cflags & P_BRANCH:
                            stack.append((coff, ckeys, 1, True))
                            pgno = self._branch_child(coff, 0)
                        else:
                            stack.append((coff, ckeys, 0, False))
                            break
                continue
            while i < len(keys):
                lo, hi, nflags, k, data_off = self._node(off, i)
                yield k, self._leaf_value(lo, hi, nflags, data_off)
                i += 1


# ---------------------------------------------------------------------------
# Writer: bottom-up bulk B+tree serialization
# ---------------------------------------------------------------------------

class _TreeWriter:
    """Serialize a sorted key-value mapping as LMDB pages into a file
    object, packing nodes the way liblmdb's append path does."""

    def __init__(self, out, psize: int):
        self.out = out
        self.psize = psize
        self.nodemax = _nodemax(psize)
        self.next_pg = 2                     # pages 0/1 are the metas
        self.branch_pages = 0
        self.leaf_pages = 0
        self.overflow_pages = 0

    def _emit(self, page_bytes: bytes) -> int:
        pgno = self.next_pg
        self.next_pg += len(page_bytes) // self.psize
        self.out.write(page_bytes)
        return pgno

    def _emit_overflow(self, value: bytes) -> int:
        npages = _ovpages(len(value), self.psize)
        buf = bytearray(npages * self.psize)
        _PAGEHDR.pack_into(buf, 0, self.next_pg, 0, P_OVERFLOW, 0, 0)
        _OVPAGES.pack_into(buf, 12, npages)
        buf[PAGEHDRSZ:PAGEHDRSZ + len(value)] = value
        self.overflow_pages += npages
        return self._emit(bytes(buf))

    def _pack_page(self, flags: int, nodes) -> bytes:
        """Nodes allocated downward from mp_upper in insertion order,
        ptr array in the same (sorted-key) order — liblmdb layout."""
        buf = bytearray(self.psize)
        ofs = self.psize
        for i, node in enumerate(nodes):
            ofs -= _even(len(node))
            buf[ofs:ofs + len(node)] = node
            struct.pack_into("<H", buf, PAGEHDRSZ + 2 * i, ofs)
        lower = PAGEHDRSZ + 2 * len(nodes)
        _PAGEHDR.pack_into(buf, 0, self.next_pg, 0, flags, lower, ofs)
        return bytes(buf)

    @staticmethod
    def _leaf_node(key: bytes, value: bytes, big_pgno=None) -> bytes:
        dsize = len(value)
        if big_pgno is None:
            return (_NODEHDR.pack(dsize & 0xFFFF, dsize >> 16, 0, len(key))
                    + key + value)
        return (_NODEHDR.pack(dsize & 0xFFFF, dsize >> 16, F_BIGDATA,
                              len(key)) + key + _PGNO.pack(big_pgno))

    @staticmethod
    def _branch_node(key: bytes, pgno: int) -> bytes:
        return _NODEHDR.pack(pgno & 0xFFFF, (pgno >> 16) & 0xFFFF,
                             (pgno >> 32) & 0xFFFF, len(key)) + key

    def build(self, items):
        """items: iterable of sorted (key, value).  Returns (root, depth,
        entries)."""
        level = []                           # (lowest_key, pgno) per page
        nodes, used, first_key, entries = [], 0, None, 0
        for key, value in items:
            entries += 1
            if not 0 < len(key) <= MAXKEYSIZE:
                raise Error(f"bad key size {len(key)} (1..{MAXKEYSIZE})")
            if NODEHDRSZ + len(key) + len(value) > self.nodemax:
                node = self._leaf_node(key, value, self._emit_overflow(value))
            else:
                node = self._leaf_node(key, value)
            need = 2 + _even(len(node))
            if nodes and PAGEHDRSZ + used + need > self.psize:
                level.append((first_key, self._emit(
                    self._pack_page(P_LEAF, nodes))))
                self.leaf_pages += 1
                nodes, used = [], 0
                first_key = None
            if first_key is None:
                first_key = key
            nodes.append(node)
            used += need
        if nodes:
            level.append((first_key, self._emit(self._pack_page(P_LEAF,
                                                                nodes))))
            self.leaf_pages += 1
        if not level:
            return P_INVALID, 0, 0
        depth = 1
        while len(level) > 1:
            depth += 1
            parents, nodes, used, first_key = [], [], 0, None
            for j, (low, pgno) in enumerate(level):
                key = b"" if not nodes else low   # node 0 key is unused
                node = self._branch_node(key, pgno)
                need = 2 + _even(len(node))
                if nodes and PAGEHDRSZ + used + need > self.psize:
                    parents.append((first_key, self._emit(
                        self._pack_page(P_BRANCH, nodes))))
                    self.branch_pages += 1
                    nodes, used, first_key = [], 0, None
                    node = self._branch_node(b"", pgno)
                    need = 2 + _even(len(node))
                if first_key is None:
                    first_key = low
                nodes.append(node)
                used += need
            parents.append((first_key, self._emit(
                self._pack_page(P_BRANCH, nodes))))
            self.branch_pages += 1
            level = parents
        return level[0][1], depth, entries


def _meta_page(pgno: int, psize: int, mapsize: int, env_flags: int,
               main_db, last_pg: int, txnid: int) -> bytes:
    buf = bytearray(psize)
    _PAGEHDR.pack_into(buf, 0, pgno, 0, P_META, 0, 0)
    off = PAGEHDRSZ
    _META_HEAD.pack_into(buf, off, MDB_MAGIC, MDB_DATA_VERSION, 0, mapsize)
    off += _META_HEAD.size
    # free DB slot: md_pad holds the page size, md_flags the env flags
    # (mdb_env_init_meta stamps INTEGERKEY for the free DB)
    _DB.pack_into(buf, off, psize, (env_flags & 0xFFFF) | MDB_INTEGERKEY,
                  0, 0, 0, 0, 0, P_INVALID)
    off += _DB.size
    _DB.pack_into(buf, off, 0, 0, *main_db)
    off += _DB.size
    _META_TAIL.pack_into(buf, off, last_pg, txnid)
    return bytes(buf)


def write_db(path: str, items: dict, psize: int = DEFAULT_PSIZE,
             txnid: int = 1, nosubdir: bool = True,
             mapsize: int | None = None) -> None:
    """Atomically write `items` as a complete LMDB data file at `path`."""
    tmp = path + ".tmp"
    with io.open(tmp, "wb") as f:
        f.write(b"\0" * (2 * psize))         # meta placeholders
        w = _TreeWriter(f, psize)
        root, depth, entries = w.build(sorted(items.items()))
        size = w.next_pg * psize
        if mapsize is None or mapsize < size:
            mapsize = size
        main_db = (depth, w.branch_pages, w.leaf_pages, w.overflow_pages,
                   entries, root)
        env_flags = MDB_NOSUBDIR if nosubdir else 0
        f.seek(0)
        # both meta slots carry the committed txn; readers pick by txnid
        f.write(_meta_page(0, psize, mapsize, env_flags, main_db,
                           w.next_pg - 1, txnid))
        f.write(_meta_page(1, psize, mapsize, env_flags, main_db,
                           w.next_pg - 1, txnid))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # pragma: no cover - exotic filesystems
        pass


# ---------------------------------------------------------------------------
# lmdb-compatible API surface
# ---------------------------------------------------------------------------

_TOMBSTONE = object()                       # pending-delete marker


class _Txn:
    """Write transactions buffer puts/deletes in a private overlay and
    apply them on commit; abort() (or an exception unwinding a
    with-block) discards them — matching real lmdb, where an aborted
    transaction leaves no trace."""

    def __init__(self, env: "Environment", write: bool):
        self._env = env
        self._write = write
        self._ops = {} if write else None   # key -> value | _TOMBSTONE
        self._done = False
        if write and env._readonly:
            raise Error("write transaction on read-only environment")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._write and not self._done:
            if exc[0] is None:
                self.commit()
            else:
                self.abort()
        return False

    def _check_live(self):
        if self._done:
            raise Error("transaction already committed/aborted")

    def get(self, key: bytes, default=None):
        key = bytes(key)
        if self._ops and key in self._ops:
            v = self._ops[key]
            return default if v is _TOMBSTONE else v
        v = self._env._get(key)
        return default if v is None else v

    def put(self, key: bytes, value: bytes, overwrite: bool = True) -> bool:
        if not self._write:
            raise Error("put on read-only transaction")
        self._check_live()
        key = bytes(key)
        if not key or len(key) > MAXKEYSIZE:
            raise Error(f"bad key size {len(key)} (1..{MAXKEYSIZE})")
        if not overwrite and self.get(key) is not None:
            return False
        self._ops[key] = bytes(value)
        return True

    def delete(self, key: bytes) -> bool:
        if not self._write:
            raise Error("delete on read-only transaction")
        self._check_live()
        key = bytes(key)
        if self.get(key) is None:
            return False
        self._ops[key] = _TOMBSTONE
        return True

    def commit(self):
        if self._write and not self._done:
            for k, v in self._ops.items():
                if v is _TOMBSTONE:
                    self._env._data.pop(k, None)
                else:
                    self._env._data[k] = v
            self._ops = {}
            self._env._persist()
        self._done = True

    def abort(self):
        if self._write:
            self._ops = {}
        self._done = True

    def cursor(self) -> "_Cursor":
        return _Cursor(self._env, self._ops or None)


class _Cursor:
    """lmdb.Cursor surface: first/next/set_key/set_range/iternext,
    iteration and context-manager use.  Streams from the mapped tree on
    read-only environments (nothing materialized).  Position semantics
    follow the real package: next() on a fresh cursor lands on the first
    record, and a cursor that has run past the end stays exhausted
    (iternext yields nothing) instead of rewinding."""

    def __init__(self, env: "Environment", ops: dict | None = None):
        self._env = env
        self._ops = ops                     # write-txn overlay, if any
        self._cur = None                    # (key, value) or None
        self._it = iter(())
        self._fresh = True                  # never positioned yet

    def _source(self, key):
        it = self._env._iter_from(key)
        if not self._ops:
            return it
        # merge the write transaction's pending puts/deletes (real lmdb
        # cursors see uncommitted writes of their own transaction)
        merged = dict(it)
        for k, v in self._ops.items():
            if v is _TOMBSTONE:
                merged.pop(k, None)
            elif key is None or k >= key:
                merged[k] = v
        return iter(sorted(merged.items()))

    def _seek(self, key=None) -> bool:
        self._fresh = False
        self._it = self._source(key)
        self._cur = next(self._it, None)
        return self._cur is not None

    # -- positioning --------------------------------------------------------
    def first(self) -> bool:
        return self._seek(None)

    def next(self) -> bool:
        if self._fresh:                     # real lmdb: first record
            return self.first()
        self._cur = next(self._it, None)
        return self._cur is not None

    def set_key(self, key: bytes) -> bool:
        if not self._seek(bytes(key)) or self._cur[0] != bytes(key):
            self._cur = None
            return False
        return True

    def set_range(self, key: bytes) -> bool:
        return self._seek(bytes(key))

    # -- access -------------------------------------------------------------
    def key(self) -> bytes:
        return self._cur[0] if self._cur else b""

    def value(self) -> bytes:
        return self._cur[1] if self._cur else b""

    def item(self):
        return self._cur if self._cur else (b"", b"")

    # -- iteration ----------------------------------------------------------
    def iternext(self, keys: bool = True, values: bool = True):
        if self._fresh and not self._seek(None):
            return
        while self._cur is not None:
            k, v = self._cur
            if keys and values:
                yield k, v
            elif keys:
                yield k
            else:
                yield v
            self._cur = next(self._it, None)

    def __iter__(self):
        return self.iternext()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self):
        pass


class Environment:
    """Read: streams from an mmap of the real file.  Write: holds the
    key-value set in memory and bulk-serializes on commit (the
    build-once/read-many model of the reference's image catalogs)."""

    def __init__(self, path: str, subdir: bool, readonly: bool,
                 map_size: int | None = None):
        self._file = os.path.join(path, "data.mdb") if subdir else path
        self._subdir = subdir
        self._readonly = readonly
        self._map_size = map_size
        self._lock = threading.Lock()
        self._txnid = 0
        self._mm = None
        self._tree = None
        self._data = None                    # write-mode overlay
        if os.path.exists(self._file):
            self._open_existing()
        elif subdir and os.path.isfile(path):
            raise Error(f"{path} exists and is not a directory")
        elif readonly:
            raise Error(f"no such database: {self._file}")
        else:
            if subdir:
                os.makedirs(path, exist_ok=True)
            self._data = {}

    def _open_existing(self):
        with io.open(self._file, "rb") as f:
            head = f.read(len(LEGACY_SHIM_MAGIC))
            if head == LEGACY_SHIM_MAGIC:
                raise Error(
                    f"{self._file} is a legacy pickle-shim database from an "
                    "earlier revision of the JAX package; rebuild it with "
                    "python -m iisan_tpu_torch.tools.build_lmdb (output is "
                    "real LMDB format)")
        self._fh = io.open(self._file, "rb")
        try:
            self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
            self._tree = _TreeReader(self._mm)
        except ValueError as e:              # e.g. zero-length file
            self.close()
            raise Error(f"cannot map {self._file}: {e}")
        except Error:
            self.close()
            raise
        self._txnid = self._tree.meta.txnid
        if not self._readonly:
            # writer over an existing DB: materialize, then extend
            self._data = dict(self._tree.iter_from(None))

    # -- backend selected by mode ------------------------------------------
    def _get(self, key: bytes):
        if self._data is not None:
            return self._data.get(key)
        return self._tree.get(key)

    def _iter_from(self, key=None):
        if self._data is not None:
            items = sorted(self._data.items())
            start = 0 if key is None else bisect_left(
                [k for k, _ in items], key)
            return iter(items[start:])
        return self._tree.iter_from(key)

    def begin(self, write: bool = False, **_kw) -> _Txn:
        return _Txn(self, write)

    def _persist(self):
        with self._lock:
            self._txnid += 1
            write_db(self._file, self._data, txnid=self._txnid,
                     nosubdir=not self._subdir, mapsize=self._map_size)

    def stat(self):
        if self._tree is not None and self._data is None:
            t = self._tree
            return {"psize": t.psize, "depth": t.depth,
                    "branch_pages": t.branch_pages,
                    "leaf_pages": t.leaf_pages,
                    "overflow_pages": t.overflow_pages,
                    "entries": t.entries}
        return {"psize": DEFAULT_PSIZE, "depth": 0, "branch_pages": 0,
                "leaf_pages": 0, "overflow_pages": 0,
                "entries": len(self._data)}

    def info(self):
        meta = self._tree.meta if self._tree is not None else None
        map_size = (meta.mapsize if meta is not None
                    else self._map_size or 0)
        return {"map_size": max(map_size, self._map_size or 0),
                "last_txnid": self._txnid,
                "last_pgno": meta.last_pg if meta is not None else 0,
                "map_addr": 0, "max_readers": 126, "num_readers": 0}

    def sync(self, force: bool = True):
        pass  # commit is durable: write_db fsyncs file and directory

    def close(self):
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        fh = getattr(self, "_fh", None)
        if fh is not None:
            fh.close()
            self._fh = None


def open(path: str, subdir: bool = True, readonly: bool = False,
         map_size: int | None = None, **_kw):
    """lmdb.open-compatible entry; extra kwargs (lock, readahead, meminit,
    map_async, create, max_dbs, ...) accepted and ignored."""
    return Environment(path, subdir=subdir, readonly=readonly,
                       map_size=map_size)
