"""Minimal HDF5 writer for FAST5 files — no libhdf5, no h5py.

Writes the subset of HDF5 that MinKNOW/albacore-era FAST5 files use and
that every reader in this package parses (native/fast5_ingest.cpp,
native/fast5_write.cpp, and h5py where it is installed): superblock v0
with 8-byte offsets, v1 object headers, symbol-table groups of at most
eight children, contiguous datasets and scalar attributes.  The byte
encodings follow native/fast5_write.cpp, which matches libhdf5's output.

``write_h5(path, tree)`` takes a nested dict: a dict value is a group, a
numpy array a dataset, ``bytes`` a scalar fixed-length string dataset; the
key ``"@attrs"`` maps attribute names to float, int, bytes or str values.
Supported element types: little-endian float64, signed/unsigned integers,
fixed-length byte strings and compounds of those.
"""

from __future__ import annotations

import struct

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF
ATTRS = "@attrs"
_LEAF_K, _INTERN_K = 4, 16          # libhdf5's default group node sizes
_SUPERBLOCK_SIZE = 96

_F64 = bytes([0x11, 0x20, 0x3F, 0x00, 8, 0, 0, 0,      # float v1, LE
              0x00, 0x00, 0x40, 0x00,                  # offset 0, prec 64
              0x34, 0x0B, 0x00, 0x34, 0xFF, 0x03, 0x00, 0x00])


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _padded(b: bytes) -> bytes:
    return b + b"\0" * (_pad8(len(b)) - len(b))


def _dtype_msg(dt: np.dtype) -> bytes:
    if dt.byteorder == ">":
        raise TypeError(f"big-endian dtype {dt} not supported")
    if dt.kind == "f" and dt.itemsize == 8:
        return _F64
    if dt.kind in "iu":
        return (bytes([0x10, 0x08 if dt.kind == "i" else 0x00, 0, 0])
                + struct.pack("<IHH", dt.itemsize, 0, 8 * dt.itemsize))
    if dt.kind == "S":
        return bytes([0x13, 0x01, 0, 0]) + struct.pack("<I", dt.itemsize)
    if dt.names:
        out = (bytes([0x16]) + struct.pack("<H", len(dt.names)) + b"\0"
               + struct.pack("<I", dt.itemsize))
        for name in dt.names:
            sub, off = dt.fields[name][:2]
            out += (_padded(name.encode() + b"\0") + struct.pack("<I", off)
                    + b"\0" * 28 + _dtype_msg(sub))
        return out
    raise TypeError(f"dtype {dt} not supported")


def _dataspace_msg(shape) -> bytes:
    if not shape:
        return bytes([1, 0, 0, 0, 0, 0, 0, 0])               # scalar
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return bytes([1, len(shape), 1, 0, 0, 0, 0, 0]) + dims + dims


def _attr_msg(name: str, value) -> bytes:
    if isinstance(value, str):
        value = value.encode()
    if isinstance(value, bytes):
        dt = np.dtype(f"S{max(len(value), 1)}")
        data = value.ljust(dt.itemsize, b"\0")
    elif isinstance(value, (int, np.integer)):
        dt, data = np.dtype("<i8"), struct.pack("<q", int(value))
    elif isinstance(value, (float, np.floating)):
        dt, data = np.dtype("<f8"), struct.pack("<d", float(value))
    else:
        raise TypeError(f"attribute {name!r}: {type(value)} not supported")
    nb = name.encode() + b"\0"
    dtm, dsm = _dtype_msg(dt), _dataspace_msg(())
    return (struct.pack("<BBHHH", 1, 0, len(nb), len(dtm), len(dsm))
            + _padded(nb) + _padded(dtm) + _padded(dsm) + data)


class _File:
    def __init__(self):
        self.buf = bytearray(_SUPERBLOCK_SIZE)

    def alloc(self, data: bytes) -> int:
        self.buf.extend(b"\0" * (_pad8(len(self.buf)) - len(self.buf)))
        addr = len(self.buf)
        self.buf.extend(data)
        return addr

    def object_header(self, msgs) -> int:
        body = b""
        for mtype, m in msgs:
            pm = _padded(m)
            body += struct.pack("<HHB3x", mtype, len(pm), 0) + pm
        return self.alloc(struct.pack("<BBHII4x", 1, 0, len(msgs), 1,
                                      len(body)) + body)

    def dataset(self, value) -> int:
        if isinstance(value, bytes):
            arr = np.array(value, dtype=f"S{max(len(value), 1)}")
        else:
            arr = np.ascontiguousarray(value)
        raw = arr.tobytes()
        addr = self.alloc(raw) if raw else UNDEF
        return self.object_header([
            (0x0001, _dataspace_msg(arr.shape)),
            (0x0003, _dtype_msg(arr.dtype)),
            (0x0005, bytes([2, 1, 2, 0])),      # fill value: early, none
            (0x0008, bytes([3, 1]) + struct.pack("<QQ", addr, len(raw))),
        ])

    def group(self, items: dict):
        """Returns (object header, B-tree, local heap) addresses."""
        kids = []
        for name, value in items.items():
            if name == ATTRS:
                continue
            addr = (self.group(value)[0] if isinstance(value, dict)
                    else self.dataset(value))
            kids.append((name.encode(), addr))
        if len(kids) > 2 * _LEAF_K:
            raise ValueError(f"group with {len(kids)} children: at most "
                             f"{2 * _LEAF_K} are supported")
        kids.sort()
        # local heap: empty name at 0, each name padded to 8, then a free
        # block (next = 1, the on-disk end of the free list)
        seg = bytearray(8)
        offs = []
        for name, _ in kids:
            offs.append(len(seg))
            seg += _padded(name + b"\0")
        free_off = len(seg)
        seg += struct.pack("<QQ", 1, 32) + b"\0" * 16
        seg_addr = self.alloc(bytes(seg))
        heap = self.alloc(b"HEAP\0\0\0\0" + struct.pack(
            "<QQQ", len(seg), free_off, seg_addr))
        entries = b"".join(struct.pack("<QQII16x", off, addr, 0, 0)
                           for off, (_, addr) in zip(offs, kids))
        snod = self.alloc(b"SNOD\x01\x00" + struct.pack("<H", len(kids))
                          + entries + b"\0" * (40 * (2 * _LEAF_K - len(kids))))
        btree = self.alloc(
            b"TREE\x00\x00" + struct.pack("<HQQ", 1, UNDEF, UNDEF)
            + struct.pack("<QQQ", 0, snod, offs[-1] if offs else 0)
            + b"\0" * (16 * (2 * _INTERN_K - 1)))
        msgs = [(0x0011, struct.pack("<QQ", btree, heap))]
        msgs += [(0x000C, _attr_msg(k, v))
                 for k, v in items.get(ATTRS, {}).items()]
        return self.object_header(msgs), btree, heap

    def finish(self, root) -> bytes:
        header, btree, heap = root
        self.buf.extend(b"\0" * (_pad8(len(self.buf)) - len(self.buf)))
        self.buf[:_SUPERBLOCK_SIZE] = (
            b"\x89HDF\r\n\x1a\n"
            + bytes([0, 0, 0, 0, 0, 8, 8, 0])
            + struct.pack("<HHI", _LEAF_K, _INTERN_K, 0)
            + struct.pack("<QQQQ", 0, UNDEF, len(self.buf), UNDEF)
            # root symbol-table entry, caching its B-tree and heap
            + struct.pack("<QQII", 0, header, 1, 0)
            + struct.pack("<QQ", btree, heap))
        return bytes(self.buf)


def h5_bytes(tree: dict) -> bytes:
    """The bytes of an HDF5 file holding `tree` (see the module doc)."""
    f = _File()
    return f.finish(f.group(tree))


def write_h5(path: str, tree: dict) -> str:
    with open(path, "wb") as out:
        out.write(h5_bytes(tree))
    return path
