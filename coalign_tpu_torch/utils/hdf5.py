"""A small HDF5 reader and writer for image packs, in numpy and zlib.

The JAX package packs a frame's camera images into ``<ts>_imgs.hdf5`` with
h5py (coalign_tpu/tools/img2hdf5.py); the port runs where h5py is absent,
so it carries the part of HDF5 that such a pack uses (the HDF5 file format
specification, version 2.0 sections):

* read_datasets: superblock version 0 (h5py's default, libver
  "earliest"); the root group's symbol table (a version-1 B-tree of type
  0 over symbol-table nodes, names in a local heap); version-1 object
  headers with continuation messages; per dataset the dataspace, a
  fixed-point datatype, the fill value, data layout version 3 (chunked
  or contiguous) and the filter pipeline with deflate (id 1) and
  shuffle (id 2). A chunked dataset's chunks are found through its
  version-1 B-tree of type 1, internal nodes included (h5py puts a
  600 x 800 x 3 image in 96 chunks of 75 x 200 x 1, more than one leaf
  holds); edge chunks are stored at full size and cropped; chunks never
  written hold the fill value. Anything else (another superblock, a
  compact layout, another filter, another datatype class, a shared
  message) raises and names it.
* write_datasets: the same layout, one chunk per dataset (the whole
  array), deflate-compressed: h5py reads the files back.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# object-header message types that read_datasets reads, or that do not
# change how the data decodes
_DATASPACE, _DATATYPE, _FILL_OLD, _FILL = 0x1, 0x3, 0x4, 0x5
_LAYOUT, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x8, 0xB, 0x10, 0x11
_IGNORED = {0x0, 0x2, 0xC, 0xD, 0xE, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17}
_MESSAGE_NAMES = {0x6: "link", 0x7: "external data files", 0x9: "bogus",
                  0xA: "group info", 0xF: "shared message table"}
_DEFLATE, _SHUFFLE = 1, 2

GROUP_LEAF_K, GROUP_INTERNAL_K, CHUNK_K = 4, 16, 32


class HDF5FormatError(ValueError):
    """A file that is not an HDF5 file of the layout this module reads."""


class _Reader:
    def __init__(self, data: bytes, path: str):
        self.d = data
        self.path = path

    def fail(self, what: str):
        raise HDF5FormatError(f"{self.path}: {what}")

    def u(self, pos: int, size: int) -> int:
        if pos + size > len(self.d):
            self.fail(f"read past the end of the file at {pos}")
        return int.from_bytes(self.d[pos:pos + size], "little")

    # -- superblock and the root group ---------------------------------
    def root(self) -> int:
        if self.d[:8] != SIGNATURE:
            self.fail("no HDF5 signature at offset 0 (a user block or not "
                      "an HDF5 file)")
        if len(self.d) < 96:
            self.fail(f"a file of {len(self.d)} bytes, shorter than a "
                      "superblock")
        version = self.d[8]
        if version != 0:
            self.fail(f"superblock version {version} (only 0, h5py's "
                      "default, is read)")
        if (self.d[13], self.d[14]) != (8, 8):
            self.fail(f"offsets of {self.d[13]} and lengths of {self.d[14]} "
                      "bytes")
        pos = 24
        self.base = self.u(pos, 8)
        entry = pos + 32                 # base, free space, EOF, driver
        return self.u(entry + 8, 8)      # the root's object header

    def group_members(self, header: int) -> dict:
        msgs = self.messages(header)
        tables = [body for kind, body in msgs if kind == _SYMBOL_TABLE]
        if not tables:
            self.fail("the root group has no symbol table (a new-style "
                      "group: libver 'latest')")
        btree, heap = struct.unpack_from("<QQ", tables[0])
        heap_data = self.local_heap(heap)
        members = {}
        for snod in self.btree_children(btree, node_type=0):
            if self.d[snod:snod + 4] != b"SNOD":
                self.fail(f"no symbol table node at {snod}")
            for i in range(self.u(snod + 6, 2)):
                e = snod + 8 + 40 * i
                name_off = self.u(e, 8)
                end = heap_data.index(b"\0", name_off)
                members[heap_data[name_off:end].decode()] = self.u(e + 8, 8)
        return members

    def local_heap(self, pos: int) -> bytes:
        if self.d[pos:pos + 4] != b"HEAP":
            self.fail(f"no local heap at {pos}")
        size, addr = self.u(pos + 8, 8), self.u(pos + 24, 8)
        return self.d[self.base + addr:self.base + addr + size]

    def btree_children(self, pos: int, node_type: int):
        """(child address, key bytes) of every leaf entry under the
        version-1 B-tree node at ``pos``, left to right; for a group tree
        (type 0) the children alone."""
        if self.d[pos:pos + 4] != b"TREE":
            self.fail(f"no B-tree node at {pos}")
        if self.d[pos + 4] != node_type:
            self.fail(f"B-tree node of type {self.d[pos + 4]} at {pos}, "
                      f"expected {node_type}")
        level, used = self.d[pos + 5], self.u(pos + 6, 2)
        key = 8 if node_type == 0 else self.key_size
        out = []
        p = pos + 24
        for _ in range(used):
            key_bytes = self.d[p:p + key]
            child = self.u(p + key, 8)
            p += key + 8
            if level > 0:
                out += self.btree_children(self.base + child, node_type)
            else:
                out.append(self.base + child if node_type == 0
                           else (self.base + child, key_bytes))
        return out

    # -- object headers --------------------------------------------------
    def messages(self, pos: int) -> list:
        """[(type, body)] of the version-1 object header at ``pos`` and
        its continuation blocks."""
        pos += self.base
        if self.d[pos] != 1:
            self.fail(f"object header version {self.d[pos]} at {pos} (only "
                      "version 1 is read; 'OHDR' headers are libver "
                      "'latest')")
        blocks = [(pos + 16, self.u(pos + 8, 4))]
        out = []
        while blocks:
            start, size = blocks.pop(0)
            p, end = start, start + size
            while p + 8 <= end:
                kind, length, flags = self.u(p, 2), self.u(p + 2, 2), \
                    self.d[p + 4]
                body = self.d[p + 8:p + 8 + length]
                p += 8 + length
                if flags & 0x2:
                    self.fail(f"shared object-header message of type "
                              f"{kind:#x}")
                if kind == _CONTINUATION:
                    addr, length = struct.unpack_from("<QQ", body)
                    blocks.append((self.base + addr, length))
                elif kind in _IGNORED:
                    continue
                elif kind in (_DATASPACE, _DATATYPE, _FILL_OLD, _FILL,
                              _LAYOUT, _FILTERS, _SYMBOL_TABLE):
                    out.append((kind, body))
                else:
                    self.fail(f"object-header message of type {kind:#x} "
                              f"({_MESSAGE_NAMES.get(kind, 'unknown')})")
        return out

    # -- datasets --------------------------------------------------------
    def dataset(self, header: int, name: str) -> np.ndarray:
        msgs = {}
        for kind, body in self.messages(header):
            msgs.setdefault(kind, body)
        for kind, what in ((_DATASPACE, "dataspace"), (_DATATYPE, "datatype"),
                           (_LAYOUT, "data layout")):
            if kind not in msgs:
                self.fail(f"{name}: no {what} message")
        shape = self._dataspace(msgs[_DATASPACE], name)
        dtype = self._datatype(msgs[_DATATYPE], name)
        fill = self._fill(msgs, dtype, name)
        filters = self._filters(msgs.get(_FILTERS), name)
        return self._data(msgs[_LAYOUT], shape, dtype, fill, filters, name)

    def _dataspace(self, body: bytes, name: str) -> tuple:
        version, rank = body[0], body[1]
        if version == 1:
            start = 8
        elif version == 2:
            if body[3] != 1:
                self.fail(f"{name}: dataspace of type {body[3]} (not "
                          "simple)")
            start = 4
        else:
            self.fail(f"{name}: dataspace version {version}")
        return struct.unpack_from(f"<{rank}Q", body, start)

    def _datatype(self, body: bytes, name: str) -> np.dtype:
        cls, bits = body[0] & 0x0F, body[1]
        size = struct.unpack_from("<I", body, 4)[0]
        if cls != 0:
            self.fail(f"{name}: datatype class {cls} (only fixed-point, "
                      "class 0, is read)")
        if size not in (1, 2, 4, 8):
            self.fail(f"{name}: fixed-point size {size}")
        order = ">" if bits & 0x1 else "<"
        return np.dtype(f"{order}{'i' if bits & 0x8 else 'u'}{size}")

    def _fill(self, msgs: dict, dtype: np.dtype, name: str):
        value = None
        if _FILL in msgs:
            body = msgs[_FILL]
            version = body[0]
            if version in (1, 2):
                defined = body[3]
                if version == 1 or defined:
                    size = struct.unpack_from("<I", body, 4)[0]
                    value = body[8:8 + size] if size else None
            elif version == 3:
                flags = body[1]
                if flags & 0x20:
                    size = struct.unpack_from("<I", body, 2)[0]
                    value = body[6:6 + size]
            else:
                self.fail(f"{name}: fill value message version {version}")
        elif _FILL_OLD in msgs:
            body = msgs[_FILL_OLD]
            size = struct.unpack_from("<I", body, 0)[0]
            value = body[4:4 + size] if size else None
        if value is None:
            return dtype.type(0)
        if len(value) != dtype.itemsize:
            self.fail(f"{name}: fill value of {len(value)} bytes")
        return np.frombuffer(value, dtype)[0]

    def _filters(self, body, name: str) -> list:
        """Filter ids of the pipeline, in the order they were applied on
        write."""
        if body is None:
            return []
        version, count = body[0], body[1]
        if version not in (1, 2):
            self.fail(f"{name}: filter pipeline version {version}")
        p = 8 if version == 1 else 2
        ids = []
        for _ in range(count):
            fid = struct.unpack_from("<H", body, p)[0]
            if version == 1 or fid >= 256:
                name_len = struct.unpack_from("<H", body, p + 2)[0]
                p += 2
            else:
                name_len = 0
            nvalues = struct.unpack_from("<H", body, p + 4)[0]
            p += 6
            if version == 1:
                p += (name_len + 7) // 8 * 8 + 4 * nvalues \
                    + (4 if nvalues % 2 else 0)
            else:
                p += name_len + 4 * nvalues
            if fid not in (_DEFLATE, _SHUFFLE):
                self.fail(f"{name}: filter {fid} (only deflate, 1, and "
                          "shuffle, 2, are read)")
            ids.append(fid)
        return ids

    def _decode(self, raw: bytes, filters: list, mask: int,
                itemsize: int) -> bytes:
        for i in reversed(range(len(filters))):
            if mask & (1 << i):
                continue
            if filters[i] == _DEFLATE:
                raw = zlib.decompress(raw)
            elif itemsize > 1:                       # shuffle
                n = len(raw) // itemsize
                raw = np.frombuffer(raw[:n * itemsize], np.uint8).reshape(
                    itemsize, n).T.tobytes() + raw[n * itemsize:]
        return raw

    def _data(self, body: bytes, shape, dtype, fill, filters, name: str):
        version, cls = body[0], body[1]
        if version != 3:
            self.fail(f"{name}: data layout version {version} (only 3 is "
                      "read; version 4 is libver 'latest')")
        count = int(np.prod(shape, dtype=np.int64))
        if cls == 1:                                      # contiguous
            addr, size = struct.unpack_from("<QQ", body, 2)
            if addr == UNDEF:
                return np.full(shape, fill, dtype)
            raw = self.d[self.base + addr:self.base + addr + size]
            return np.frombuffer(raw, dtype, count).reshape(shape).copy()
        if cls != 2:
            self.fail(f"{name}: data layout class {cls} (only contiguous, 1, "
                      "and chunked, 2, are read)")
        ndims = body[2]
        addr = struct.unpack_from("<Q", body, 3)[0]
        dims = struct.unpack_from(f"<{ndims}I", body, 11)
        chunk = dims[:-1]
        if len(chunk) != len(shape) or dims[-1] != dtype.itemsize:
            self.fail(f"{name}: chunk dims {dims} for shape {shape}")
        out = np.full(shape, fill, dtype)
        if addr == UNDEF:
            return out
        self.key_size = 8 + 8 * ndims
        for child, key in self.btree_children(self.base + addr, 1):
            size, mask = struct.unpack_from("<II", key)
            offset = struct.unpack_from(f"<{ndims}Q", key, 8)[:-1]
            raw = self._decode(self.d[child:child + size], filters, mask,
                               dtype.itemsize)
            block = np.frombuffer(raw, dtype, int(np.prod(chunk))).reshape(
                chunk)
            region = tuple(slice(o, min(o + c, s))
                           for o, c, s in zip(offset, chunk, shape))
            out[region] = block[tuple(slice(0, r.stop - r.start)
                                      for r in region)]
        return out


def read_datasets(path: str, names=None) -> dict:
    """{name: array} of the datasets at the root of the HDF5 file ``path``
    (those of ``names`` only, where given; a name the file lacks is left
    out). Raises HDF5FormatError on a layout this module does not read."""
    with open(path, "rb") as f:
        r = _Reader(f.read(), path)
    members = r.group_members(r.root())
    wanted = members if names is None else [n for n in names
                                            if n in members]
    return {n: r.dataset(members[n], n) for n in wanted}


# -- writer ----------------------------------------------------------------


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(kind: int, body: bytes) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", kind, len(body), 0) + body


def _object_header(messages: list) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _btree_node(node_type: int, k: int, key_size: int, keys: list,
                children: list) -> bytes:
    """A level-0 version-1 B-tree node, padded to the full size of a node
    of ``2k`` entries (the size the library reads)."""
    node = b"TREE" + struct.pack("<BBHQQ", node_type, 0, len(children),
                                 UNDEF, UNDEF)
    for key, child in zip(keys, children):
        node += key + struct.pack("<Q", child)
    node += keys[-1]
    full = 24 + (2 * k + 1) * key_size + 2 * k * 8
    return node + b"\0" * (full - len(node))


def write_datasets(path: str, arrays: dict, level: int = 1):
    """Write ``arrays`` ({name: integer array}) as datasets at the root of
    a new HDF5 file ``path``: superblock version 0, one deflate-compressed
    chunk per dataset (``level`` as h5py's compression_opts), the layout
    read_datasets reads and h5py reads back."""
    names = sorted(arrays)
    if not names or len(names) > 2 * GROUP_LEAF_K * 2 * GROUP_INTERNAL_K:
        raise ValueError(f"{len(names)} datasets")
    out = bytearray(b"\0" * 96)                       # the superblock

    def put(blob: bytes) -> int:
        pos = len(out)
        out.extend(blob)
        out.extend(b"\0" * (-len(out) % 8))
        return pos

    # the local heap of the names: "" at offset 0, then each name
    heap_data, offsets = bytearray(b"\0" * 8), {}
    for n in names:
        offsets[n] = len(heap_data)
        heap_data += _pad8(n.encode() + b"\0")
    # free-list head 1: the library's "no free block"
    heap_pos = put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1,
                                         0))
    out[heap_pos + 24:heap_pos + 32] = struct.pack("<Q", put(bytes(heap_data)))

    headers = {}
    for n in names:
        a = np.ascontiguousarray(arrays[n])
        if a.dtype.kind not in "ui" or a.ndim == 0:
            raise ValueError(f"{n}: only integer arrays are written, got "
                             f"{a.dtype} of shape {a.shape}")
        a = a.astype(a.dtype.newbyteorder("<"), copy=False)
        data = zlib.compress(a.tobytes(), level)
        chunk_pos = put(data)
        ndims = a.ndim + 1
        key_size = 8 + 8 * ndims
        keys = [struct.pack(f"<II{ndims}Q", len(data), 0, *([0] * ndims)),
                struct.pack(f"<II{ndims}Q", 0, 0, *a.shape, 0)]
        tree_pos = put(_btree_node(1, CHUNK_K, key_size, keys, [chunk_pos]))
        bits = 0x8 if a.dtype.kind == "i" else 0
        msgs = [
            _message(_DATASPACE, struct.pack(f"<BBBx4x{a.ndim}Q", 1, a.ndim,
                                             0, *a.shape)),
            _message(_DATATYPE, struct.pack("<BBBBIHH", 0x10, bits, 0, 0,
                                            a.dtype.itemsize, 0,
                                            8 * a.dtype.itemsize)),
            # version 2: allocation incremental, fill written if set, none
            _message(_FILL, struct.pack("<BBBB", 2, 2, 2, 0)),
            _message(_LAYOUT, struct.pack(f"<BBBQ{ndims}I", 3, 2, ndims,
                                          tree_pos, *a.shape,
                                          a.dtype.itemsize)),
            _message(_FILTERS, struct.pack("<BB6xHHHH8sI4x", 1, 1,
                                           _DEFLATE, 8, 1, 1, b"deflate",
                                           level))]
        headers[n] = put(_object_header(msgs))

    # the root group: symbol-table nodes of up to 2 * leaf K entries under
    # one B-tree node
    per_node = 2 * GROUP_LEAF_K
    snods, keys = [], [struct.pack("<Q", 0)]
    for start in range(0, len(names), per_node):
        group = names[start:start + per_node]
        node = b"SNOD" + struct.pack("<BBH", 1, 0, len(group))
        for n in group:
            node += struct.pack("<QQII16x", offsets[n], headers[n], 0, 0)
        node += b"\0" * (8 + 40 * per_node - len(node))
        snods.append(put(node))
        keys.append(struct.pack("<Q", offsets[group[-1]]))
    tree_pos = put(_btree_node(0, GROUP_INTERNAL_K, 8, keys, snods))
    root_pos = put(_object_header([_message(
        _SYMBOL_TABLE, struct.pack("<QQ", tree_pos, heap_pos))]))

    out[:96] = (SIGNATURE
                + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                              GROUP_LEAF_K, GROUP_INTERNAL_K, 0)
                + struct.pack("<QQQQ", 0, UNDEF, len(out), UNDEF)
                + struct.pack("<QQII", 0, root_pos, 1, 0)
                + struct.pack("<QQ", tree_pos, heap_pos))
    with open(path, "wb") as f:
        f.write(bytes(out))
