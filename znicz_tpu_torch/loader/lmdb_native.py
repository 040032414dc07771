"""A pure-Python read-only LMDB (``data.mdb``) reader and a bulk writer.

Counterpart of ``znicz_tpu/loader/lmdb_native.py`` (the port keeps its
own copy): the on-disk format implemented from liblmdb's layout
(mdb.c) for machines without the ``lmdb`` extension.  4096-byte pages,
two meta pages, a B+tree of branch and leaf pages for the MAIN
database, overflow-page chains for big values.  :class:`LMDBReader`
reads any standard single-process ``data.mdb``; :func:`write_lmdb`
bulk-builds one bottom-up (mdb_load's strategy), byte for byte as the
JAX package's does.

Layout (struct names from mdb.c):

* page header, 16 bytes: pgno u64 | pad u16 | flags u16 |
  (lower u16, upper u16) or, for overflow pages, pages u32.
  The node-pointer array (u16 offsets from the page's start) follows;
  nodes are packed downward from ``upper``.
* node, 8-byte header: lo u16 | hi u16 | flags u16 | ksize u16 | key |
  data.  Leaf: datasize = lo | hi<<16; F_BIGDATA (0x01) stores an
  8-byte overflow pgno instead of inline data.  Branch: child pgno =
  lo | hi<<16 | flags<<32 (node 0 has an empty key).
* meta (offset 16 on pages 0 and 1): magic 0xBEEFC0DE u32 | version
  u32 | address u64 | mapsize u64 | MDB_db[2] (FREE, MAIN) | last_pg
  u64 | txnid u64.  MDB_db, 48 bytes: pad u32 | flags u16 | depth u16 |
  branch_pages u64 | leaf_pages u64 | overflow_pages u64 | entries u64
  | root u64.  The live meta is the one with the larger txnid.
"""

import os
import struct

PAGESIZE = 4096
PAGEHDRSZ = 16
NODEHDRSZ = 8

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01

MDB_MAGIC = 0xBEEFC0DE
MDB_VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF

_META = struct.Struct("<II Q Q")          # magic, version, address, mapsize
_DB = struct.Struct("<I H H Q Q Q Q Q")   # pad,flags,depth,branch,leaf,ovf,
                                          # entries,root
_PAGEHDR = struct.Struct("<Q H H H H")    # pgno, pad, flags, lower, upper
_NODEHDR = struct.Struct("<H H H H")      # lo, hi, flags, ksize


class LMDBError(Exception):
    pass


class LMDBReader(object):
    """Read-only cursor over the MAIN database of a data.mdb file."""

    def __init__(self, path):
        import mmap
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        with open(path, "rb") as f:
            # map, don't slurp: real Caffe DBs are tens of GB and the
            # streaming loaders exist precisely to avoid holding them
            self._buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self.path = path
        # liblmdb sizes pages from the creating host's OS page size and
        # records it in the meta's FREE-db pad field (mm_psize); meta page
        # 0 sits at offset 0 regardless of stride, so read it from there,
        # falling back to probing meta page 1 when implausible
        self.pagesize = PAGESIZE
        meta0 = self._parse_meta(0)
        psize = meta0["free"]["pad"] if meta0 else 0
        if 512 <= psize <= 65536 and psize & (psize - 1) == 0:
            self.pagesize = psize
        else:
            for candidate in (4096, 8192, 16384, 32768, 65536):
                self.pagesize = candidate
                if self._parse_meta(1) is not None:
                    break
            else:
                self.pagesize = PAGESIZE
        meta = None
        for pgno in (0, 1):
            m = self._parse_meta(pgno)
            if m is not None and (meta is None or m["txnid"] > meta["txnid"]):
                meta = m
        if meta is None:
            raise LMDBError("%s: no valid LMDB meta page" % path)
        self._main = meta["main"]
        self.entries = self._main["entries"]

    def _parse_meta(self, pgno):
        off = pgno * self.pagesize
        if len(self._buf) < off + PAGEHDRSZ + _META.size + 2 * _DB.size + 16:
            return None
        _, _, flags, _, _ = _PAGEHDR.unpack_from(self._buf, off)
        if not flags & P_META:
            return None
        magic, version, _, _ = _META.unpack_from(self._buf, off + PAGEHDRSZ)
        if magic != MDB_MAGIC or version != MDB_VERSION:
            return None
        dbs_off = off + PAGEHDRSZ + _META.size
        free = _DB.unpack_from(self._buf, dbs_off)
        main = _DB.unpack_from(self._buf, dbs_off + _DB.size)
        last_pg, txnid = struct.unpack_from(
            "<QQ", self._buf, dbs_off + 2 * _DB.size)
        names = ("pad", "flags", "depth", "branch_pages", "leaf_pages",
                 "overflow_pages", "entries", "root")
        return {"txnid": txnid, "last_pg": last_pg,
                "free": dict(zip(names, free)),
                "main": dict(zip(names, main))}

    # -- page access --------------------------------------------------------
    def _page(self, pgno):
        off = pgno * self.pagesize
        if off + self.pagesize > len(self._buf):
            raise LMDBError("page %d out of range" % pgno)
        return off

    def _page_nodes(self, off):
        _, _, flags, lower, _ = _PAGEHDR.unpack_from(self._buf, off)
        if flags & P_LEAF2:
            raise LMDBError("MDB_DUPFIXED leaf2 pages are not supported")
        nkeys = (lower - PAGEHDRSZ) // 2
        ptrs = struct.unpack_from("<%dH" % nkeys, self._buf, off + PAGEHDRSZ)
        return flags, ptrs

    def _node(self, page_off, ptr):
        off = page_off + ptr
        lo, hi, flags, ksize = _NODEHDR.unpack_from(self._buf, off)
        key = self._buf[off + NODEHDRSZ:off + NODEHDRSZ + ksize]
        return lo, hi, flags, key, off + NODEHDRSZ + ksize

    def _leaf_value(self, lo, hi, nflags, data_off):
        dsize = lo | (hi << 16)
        if nflags & F_BIGDATA:
            (ovf_pgno,) = struct.unpack_from("<Q", self._buf, data_off)
            ooff = self._page(ovf_pgno)
            _, _, oflags, novf_lo, novf_hi = _PAGEHDR.unpack_from(
                self._buf, ooff)
            if not oflags & P_OVERFLOW:
                raise LMDBError("bigdata pgno %d is not an overflow page"
                                % ovf_pgno)
            start = ooff + PAGEHDRSZ
            return self._buf[start:start + dsize]
        return self._buf[data_off:data_off + dsize]

    # -- public api ---------------------------------------------------------
    def items(self):
        """Yield (key, value) in key order (cursor-iteration parity)."""
        root = self._main["root"]
        if root == P_INVALID:
            return
        yield from self._walk(root)

    def _walk(self, pgno):
        off = self._page(pgno)
        flags, ptrs = self._page_nodes(off)
        if flags & P_LEAF:
            for ptr in ptrs:
                lo, hi, nflags, key, data_off = self._node(off, ptr)
                yield bytes(key), bytes(
                    self._leaf_value(lo, hi, nflags, data_off))
        elif flags & P_BRANCH:
            for ptr in ptrs:
                lo, hi, nflags, _, _ = self._node(off, ptr)
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._walk(child)
        else:
            raise LMDBError("unexpected page flags 0x%x" % flags)

    def get(self, key):
        """Point lookup by binary-search descent."""
        pgno = self._main["root"]
        if pgno == P_INVALID:
            return None
        while True:
            off = self._page(pgno)
            flags, ptrs = self._page_nodes(off)
            if flags & P_LEAF:
                for ptr in ptrs:  # pages hold <~100 nodes; linear is fine
                    lo, hi, nflags, nkey, data_off = self._node(off, ptr)
                    if bytes(nkey) == key:
                        return bytes(
                            self._leaf_value(lo, hi, nflags, data_off))
                return None
            child = None
            for ptr in ptrs:
                lo, hi, nflags, nkey, _ = self._node(off, ptr)
                this = lo | (hi << 16) | (nflags << 32)
                if nkey and bytes(nkey) > key:
                    break
                child = this
            if child is None:  # key below the first separator
                lo, hi, nflags, _, _ = self._node(off, ptrs[0])
                child = lo | (hi << 16) | (nflags << 32)
            pgno = child


# -- fixture/bulk writer ----------------------------------------------------

def _even(n):
    return n + (n & 1)


def write_lmdb(path, items):
    """Bulk-build a data.mdb from (key, value) pairs (sorted internally).

    The mdb_load strategy: pack sorted leaves, then branch levels up to a
    single root.  Values too big to share a leaf page go to overflow
    chains.  Returns the file path.
    """
    if os.path.isdir(path) or path.endswith(os.sep) or "." not in \
            os.path.basename(path):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "data.mdb")
    items = sorted((bytes(k), bytes(v)) for k, v in items)
    for k, _ in items:
        if len(k) > 511:  # liblmdb mdb_env_get_maxkeysize default
            raise LMDBError(
                "key of %d bytes exceeds LMDB's 511-byte limit" % len(k))
    space = PAGESIZE - PAGEHDRSZ
    next_pgno = 2
    pages = {}   # pgno -> bytes
    n_leaf = n_branch = n_ovf = 0

    def alloc():
        nonlocal next_pgno
        pgno = next_pgno
        next_pgno += 1
        return pgno

    def write_page(pgno, flags, nodes):
        """nodes: list of (node_header_bytes..., key, data) raw bytes."""
        buf = bytearray(PAGESIZE)
        ptrs = []
        upper = PAGESIZE
        for raw in reversed(nodes):
            upper -= _even(len(raw))
            buf[upper:upper + len(raw)] = raw
            ptrs.append(upper)
        ptrs.reverse()
        lower = PAGEHDRSZ + 2 * len(nodes)
        _PAGEHDR.pack_into(buf, 0, pgno, 0, flags, lower, upper)
        struct.pack_into("<%dH" % len(ptrs), buf, PAGEHDRSZ, *ptrs)
        pages[pgno] = bytes(buf)

    def leaf_node(key, value):
        nonlocal n_ovf
        inline = NODEHDRSZ + len(key) + len(value)
        # liblmdb sends data to overflow when the node exceeds nodemax
        # (~half a page); mirror that threshold
        if inline > (PAGESIZE - PAGEHDRSZ) // 2 and \
                NODEHDRSZ + len(key) + 8 <= (PAGESIZE - PAGEHDRSZ) // 2:
            novf = -(-len(value) // (PAGESIZE - PAGEHDRSZ))
            ovf_pgno = None
            data = value
            first = alloc()
            for i in range(novf - 1):
                alloc()
            n_ovf += novf
            buf = bytearray(novf * PAGESIZE)
            struct.pack_into("<QHHI", buf, 0, first, 0, P_OVERFLOW, novf)
            buf[PAGEHDRSZ:PAGEHDRSZ + len(data)] = data
            for i in range(novf):
                pages[first + i] = bytes(
                    buf[i * PAGESIZE:(i + 1) * PAGESIZE])
            dsize = len(value)
            hdr = _NODEHDR.pack(dsize & 0xFFFF, dsize >> 16, F_BIGDATA,
                                len(key))
            return hdr + key + struct.pack("<Q", first)
        dsize = len(value)
        hdr = _NODEHDR.pack(dsize & 0xFFFF, dsize >> 16, 0, len(key))
        return hdr + key + value

    def branch_node(key, pgno):
        return _NODEHDR.pack(pgno & 0xFFFF, (pgno >> 16) & 0xFFFF,
                             (pgno >> 32) & 0xFFFF, len(key)) + key

    # pack leaves
    level = []  # (first_key, pgno)
    cur_nodes, cur_first, cur_used = [], None, 0
    for key, value in items:
        raw = leaf_node(key, value)
        sz = _even(len(raw)) + 2
        if cur_nodes and cur_used + sz > space:
            pgno = alloc()
            write_page(pgno, P_LEAF, cur_nodes)
            n_leaf += 1
            level.append((cur_first, pgno))
            cur_nodes, cur_used = [], 0
        if not cur_nodes:
            cur_first = key
        cur_nodes.append(raw)
        cur_used += sz
    pgno = alloc()
    write_page(pgno, P_LEAF, cur_nodes)  # possibly empty leaf for empty db
    n_leaf += 1
    level.append((cur_first or b"", pgno))
    depth = 1

    # pack branches up to a single root
    while len(level) > 1:
        nxt = []
        cur_nodes, cur_first, cur_used = [], None, 0
        for i, (first_key, child) in enumerate(level):
            key = b"" if not cur_nodes else first_key
            raw = branch_node(key, child)
            sz = _even(len(raw)) + 2
            if cur_nodes and cur_used + sz > space:
                pg = alloc()
                write_page(pg, P_BRANCH, cur_nodes)
                n_branch += 1
                nxt.append((cur_nodes_first, pg))
                cur_nodes, cur_used = [], 0
                raw = branch_node(b"", child)
                sz = _even(len(raw)) + 2
            if not cur_nodes:
                cur_nodes_first = first_key
            cur_nodes.append(raw)
            cur_used += sz
        pg = alloc()
        write_page(pg, P_BRANCH, cur_nodes)
        n_branch += 1
        nxt.append((cur_nodes_first, pg))
        level = nxt
        depth += 1

    root = level[0][1]
    last_pg = next_pgno - 1

    def meta_page(pgno, txnid):
        buf = bytearray(PAGESIZE)
        _PAGEHDR.pack_into(buf, 0, pgno, 0, P_META, 0, 0)
        # mapsize must cover the whole file (liblmdb maps this many bytes)
        _META.pack_into(buf, PAGEHDRSZ, MDB_MAGIC, MDB_VERSION, 0,
                        max(next_pgno * PAGESIZE, 1 << 20))
        dbs = PAGEHDRSZ + _META.size
        # FREE db; its pad field doubles as mm_psize in the meta layout
        _DB.pack_into(buf, dbs, PAGESIZE, 0, 0, 0, 0, 0, 0, P_INVALID)
        _DB.pack_into(buf, dbs + _DB.size, 0, 0, depth, n_branch, n_leaf,
                      n_ovf, len(items), root)                    # MAIN
        struct.pack_into("<QQ", buf, dbs + 2 * _DB.size, last_pg, txnid)
        return bytes(buf)

    with open(path, "wb") as f:
        f.write(meta_page(0, 0))
        f.write(meta_page(1, 1))
        for pgno in range(2, next_pgno):
            f.write(pages[pgno])
    return path
