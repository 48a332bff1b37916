"""A minimal pure-Python HDF5 reader/writer with the subset of h5py's API
that the host layer (``calamity_tpu_torch.io``, a copy of
``calamity_tpu.io``) uses.

The host layer (uvh5, calh5 and UVFlag files) imports ``h5py`` at module
level. Where h5py is not installed, ``calamity_tpu_torch`` registers
this module under that name, so the host layer imports and its file I/O
works. Where h5py is installed, this module is not used.

What it writes: HDF5 with a version-2 superblock and version-2 object
headers (the "latest" file format), groups with compact link storage,
contiguous datasets of little-endian integers, floats, booleans (h5py's
enum of int8 FALSE/TRUE), complex numbers (h5py's compound of r and i) and
fixed-length byte strings. h5py reads these files. What it reads: files it
wrote itself (no chunked or compressed datasets, no attributes, no
symbol-table groups).

API: ``File(path, "r" | "w")`` as a context manager; groups support
``create_group``, ``create_dataset(name, data=...)``, ``group[name] =
value``, ``name in group``, ``group[name]`` and ``keys()``; datasets
support ``ds[()]`` (and other indexing, after a full read), ``shape``,
``dtype``, ``read_direct(out)`` and ``np.asarray(ds)``.
"""

from __future__ import annotations

import struct

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_SUPERBLOCK_SIZE = 48

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_VALUE, _LINK, _LAYOUT, _GROUP_INFO = (
    0x01, 0x02, 0x03, 0x05, 0x06, 0x08, 0x0A
)


def _rot(x, k):
    return ((x << k) | (x >> (32 - k))) & 0xFFFFFFFF


def lookup3(data, initval=0):
    """Bob Jenkins' lookup3 ``hashlittle``: HDF5's metadata checksum."""
    m = 0xFFFFFFFF
    length = len(data)
    a = b = c = (0xDEADBEEF + length + initval) & m
    if length == 0:
        return c
    off = 0
    while length > 12:
        a = (a + int.from_bytes(data[off:off + 4], "little")) & m
        b = (b + int.from_bytes(data[off + 4:off + 8], "little")) & m
        c = (c + int.from_bytes(data[off + 8:off + 12], "little")) & m
        a = (a - c) & m; a ^= _rot(c, 4); c = (c + b) & m  # noqa: E702
        b = (b - a) & m; b ^= _rot(a, 6); a = (a + c) & m  # noqa: E702
        c = (c - b) & m; c ^= _rot(b, 8); b = (b + a) & m  # noqa: E702
        a = (a - c) & m; a ^= _rot(c, 16); c = (c + b) & m  # noqa: E702
        b = (b - a) & m; b ^= _rot(a, 19); a = (a + c) & m  # noqa: E702
        c = (c - b) & m; c ^= _rot(b, 4); b = (b + a) & m  # noqa: E702
        length -= 12
        off += 12
    tail = bytes(data[off:off + length]) + bytes(12 - length)
    a = (a + int.from_bytes(tail[0:4], "little")) & m
    b = (b + int.from_bytes(tail[4:8], "little")) & m
    c = (c + int.from_bytes(tail[8:12], "little")) & m
    c ^= b; c = (c - _rot(b, 14)) & m  # noqa: E702
    a ^= c; a = (a - _rot(c, 11)) & m  # noqa: E702
    b ^= a; b = (b - _rot(a, 25)) & m  # noqa: E702
    c ^= b; c = (c - _rot(b, 16)) & m  # noqa: E702
    a ^= c; a = (a - _rot(c, 4)) & m  # noqa: E702
    b ^= a; b = (b - _rot(a, 14)) & m  # noqa: E702
    c ^= b; c = (c - _rot(b, 24)) & m  # noqa: E702
    return c


# ---------------------------------------------------------------------- #
# datatypes
# ---------------------------------------------------------------------- #
_FLOAT_LAYOUT = {  # size: (sign location, exponent location, size, mantissa size, bias)
    4: (31, 23, 8, 23, 127),
    8: (63, 52, 11, 52, 1023),
}


def _encode_dtype(dt):
    """HDF5 datatype message for a numpy dtype."""
    dt = np.dtype(dt)
    if dt.kind in "iu":
        bits = 0x08 if dt.kind == "i" else 0x00
        return (bytes([0x10, bits, 0, 0]) + struct.pack("<I", dt.itemsize)
                + struct.pack("<HH", 0, 8 * dt.itemsize))
    if dt.kind == "f" and dt.itemsize in _FLOAT_LAYOUT:
        sign, eloc, esize, msize, bias = _FLOAT_LAYOUT[dt.itemsize]
        return (bytes([0x11, 0x20, sign, 0]) + struct.pack("<I", dt.itemsize)
                + struct.pack("<HHBBBBI", 0, 8 * dt.itemsize, eloc, esize, 0, msize, bias))
    if dt.kind == "b":
        # h5py's boolean: enum of signed int8 with FALSE=0, TRUE=1
        base = _encode_dtype(np.int8)
        return (bytes([0x38, 2, 0, 0]) + struct.pack("<I", 1) + base
                + b"FALSE\x00TRUE\x00" + bytes([0, 1]))
    if dt.kind == "c":
        half = np.dtype(f"<f{dt.itemsize // 2}")
        member = _encode_dtype(half)
        return (bytes([0x36, 2, 0, 0]) + struct.pack("<I", dt.itemsize)
                + b"r\x00" + bytes([0]) + member
                + b"i\x00" + bytes([half.itemsize]) + member)
    if dt.kind == "S":
        # null-padded ASCII, h5py's mapping of numpy fixed-length bytes
        return bytes([0x13, 0x01, 0, 0]) + struct.pack("<I", dt.itemsize)
    raise TypeError(f"dtype {dt} is not supported by this HDF5 writer")


def _decode_dtype(buf, pos):
    """(numpy dtype, position after the message) of a datatype message."""
    cls = buf[pos] & 0x0F
    version = buf[pos] >> 4
    bits = buf[pos + 1:pos + 4]
    size = struct.unpack_from("<I", buf, pos + 4)[0]
    p = pos + 8
    if cls in (0, 1) and bits[0] & 0x01:
        raise ValueError("big-endian data is not supported")
    if cls == 0:
        signed = bool(bits[0] & 0x08)
        return np.dtype(f"<{'i' if signed else 'u'}{size}"), p + 4
    if cls == 1:
        return np.dtype(f"<f{size}"), p + 12
    if cls == 3:
        return np.dtype(f"S{size}"), p
    if cls == 6 and version == 3:
        nmembers = bits[0] | (bits[1] << 8)
        offsize = max(1, (size.bit_length() + 7) // 8)
        names, types = [], []
        for _ in range(nmembers):
            end = buf.index(b"\x00", p)
            names.append(bytes(buf[p:end]).decode())
            p = end + 1 + offsize
            mdt, p = _decode_dtype(buf, p)
            types.append(mdt)
        if names == ["r", "i"] and types[0] == types[1] and types[0].kind == "f":
            return np.dtype(f"<c{size}"), p
        raise ValueError(f"compound type {names} is not supported")
    if cls == 8 and version == 3:
        nmembers = bits[0] | (bits[1] << 8)
        base, p = _decode_dtype(buf, p)
        names = []
        for _ in range(nmembers):
            end = buf.index(b"\x00", p)
            names.append(bytes(buf[p:end]))
            p = end + 1
        p += nmembers * base.itemsize
        if sorted(names) == [b"FALSE", b"TRUE"] and base.itemsize == 1:
            return np.dtype(bool), p
        return base, p
    raise ValueError(f"datatype class {cls} version {version} is not supported")


# ---------------------------------------------------------------------- #
# object headers
# ---------------------------------------------------------------------- #
def _object_header(messages):
    """Version-2 object header ("OHDR") holding ``messages``
    [(type, body), ...] in one chunk, with its checksum."""
    body = b"".join(struct.pack("<BHB", mtype, len(data), 0) + data for mtype, data in messages)
    head = b"OHDR" + bytes([2, 0x02]) + struct.pack("<I", len(body)) + body
    return head + struct.pack("<I", lookup3(head))


def _parse_object_header(buf, addr):
    """[(type, body), ...] of a version-2 object header at ``addr``."""
    if bytes(buf[addr:addr + 4]) != b"OHDR" or buf[addr + 4] != 2:
        raise ValueError(f"no version-2 object header at {addr}")
    flags = buf[addr + 5]
    p = addr + 6
    if flags & 0x20:
        p += 16  # access, modification, change and birth times
    if flags & 0x10:
        p += 4  # attribute phase-change values
    nsize = 1 << (flags & 0x03)
    chunk = int.from_bytes(buf[p:p + nsize], "little")
    p += nsize
    end = p + chunk
    msgs = []
    while p + 4 <= end:
        mtype = buf[p]
        size = struct.unpack_from("<H", buf, p + 1)[0]
        p += 4 + (2 if flags & 0x04 else 0)
        if mtype == 0x10:
            raise ValueError("object header continuation is not supported")
        msgs.append((mtype, bytes(buf[p:p + size])))
        p += size
    return msgs


class Dataset:
    """A dataset: written when created, read on access."""

    def __init__(self, file, shape, dtype, address, nbytes):
        self._file = file
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._address = address
        self._nbytes = nbytes

    def _read(self):
        count = int(np.prod(self.shape, dtype=np.int64))
        if count == 0:
            return np.zeros(self.shape, dtype=self.dtype)
        arr = np.frombuffer(self._file._buf, dtype=self.dtype, count=count,
                            offset=self._address)
        return arr.reshape(self.shape).copy()

    def __getitem__(self, key):
        return self._read()[key]

    def __array__(self, dtype=None, copy=None):
        arr = self._read()
        return arr if dtype is None else arr.astype(dtype)

    def read_direct(self, out):
        out[...] = self._read()

    def __len__(self):
        return self.shape[0]


class Group:
    """A group: named children, each a Group or a Dataset."""

    def __init__(self, file):
        self._file = file
        self._children = {}

    def __contains__(self, name):
        return name in self._children

    def __getitem__(self, name):
        node = self
        for part in name.strip("/").split("/"):
            node = node._children[part]
        return node

    def keys(self):
        return self._children.keys()

    def __iter__(self):
        return iter(self._children)

    def create_group(self, name):
        self._file._check_writable()
        if name in self._children:
            raise ValueError(f"{name!r} already exists")
        grp = Group(self._file)
        self._children[name] = grp
        return grp

    def create_dataset(self, name, data):
        self._file._check_writable()
        if name in self._children:
            raise ValueError(f"{name!r} already exists")
        arr = np.asarray(data)
        if arr.dtype.kind == "S" and arr.dtype.itemsize == 0:
            arr = arr.astype("S1")
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        ds = self._file._write_dataset(arr)
        self._children[name] = ds
        return ds

    def __setitem__(self, name, value):
        self.create_dataset(name, data=value)


class File(Group):
    """An HDF5 file opened for reading ("r") or writing ("w", truncates)."""

    def __init__(self, path, mode="r"):
        super().__init__(self)
        self._path = path
        self._mode = mode
        self._fh = None
        if mode == "w":
            self._fh = open(path, "wb")
            self._fh.write(bytes(_SUPERBLOCK_SIZE))
        elif mode == "r":
            with open(path, "rb") as fh:
                self._buf = memoryview(fh.read())
            self._load()
        else:
            raise ValueError(f"mode {mode!r} is not supported (use 'r' or 'w')")

    # -- writing --------------------------------------------------------- #
    def _check_writable(self):
        if self._mode != "w" or self._fh is None:
            raise ValueError("file is not open for writing")

    def _append(self, data):
        addr = self._fh.tell()
        self._fh.write(data)
        return addr

    def _write_dataset(self, arr):
        arr = np.require(arr, requirements="C")  # keeps 0-d arrays 0-d
        nbytes = arr.nbytes
        addr = self._append(memoryview(arr).cast("B")) if nbytes else _UNDEF
        if arr.ndim == 0:
            space = bytes([2, 0, 0, 0])
        else:
            space = bytes([2, arr.ndim, 0, 1]) + struct.pack(f"<{arr.ndim}Q", *arr.shape)
        layout = bytes([3, 1]) + struct.pack("<QQ", addr, nbytes)
        header = _object_header([
            (_DATASPACE, space),
            (_DATATYPE, _encode_dtype(arr.dtype)),
            (_FILL_VALUE, bytes([3, 0x0A])),
            (_LAYOUT, layout),
        ])
        ds = Dataset(self, arr.shape, arr.dtype, addr, nbytes)
        ds._header = self._append(header)
        return ds

    def _write_group(self, grp):
        links = []
        for name, child in grp._children.items():
            addr = self._write_group(child) if isinstance(child, Group) else child._header
            raw = name.encode()
            if len(raw) > 255:
                raise ValueError(f"link name too long: {name!r}")
            links.append((_LINK, bytes([1, 0, len(raw)]) + raw + struct.pack("<Q", addr)))
        info = bytes([0, 0]) + struct.pack("<QQ", _UNDEF, _UNDEF)
        return self._append(_object_header([(_LINK_INFO, info), (_GROUP_INFO, bytes([0, 0]))]
                                           + links))

    def close(self):
        if self._fh is None:
            return
        if self._mode == "w":
            root = self._write_group(self)
            eof = self._fh.tell()
            sb = (_SIGNATURE + bytes([2, 8, 8, 0])
                  + struct.pack("<QQQQ", 0, _UNDEF, eof, root))
            self._fh.seek(0)
            self._fh.write(sb + struct.pack("<I", lookup3(sb)))
        self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- reading --------------------------------------------------------- #
    def _load(self):
        buf = self._buf
        if bytes(buf[:8]) != _SIGNATURE or buf[8] not in (2, 3):
            raise ValueError(f"{self._path}: not an HDF5 file with a version-2/3 superblock")
        if buf[9] != 8 or buf[10] != 8:
            raise ValueError(f"{self._path}: only 8-byte offsets and lengths are supported")
        root = struct.unpack_from("<Q", buf, 36)[0]
        self._children = self._read_group(root)._children

    def _read_group(self, addr):
        grp = Group(self)
        for mtype, data in _parse_object_header(self._buf, addr):
            if mtype != _LINK:
                continue
            flags = data[1]
            p = 2
            if flags & 0x08:
                if data[p] != 0:
                    raise ValueError("only hard links are supported")
                p += 1
            if flags & 0x04:
                p += 8
            if flags & 0x10:
                p += 1
            nlen_size = 1 << (flags & 0x03)
            nlen = int.from_bytes(data[p:p + nlen_size], "little")
            p += nlen_size
            name = data[p:p + nlen].decode()
            target = struct.unpack_from("<Q", data, p + nlen)[0]
            grp._children[name] = self._read_node(target)
        return grp

    def _read_node(self, addr):
        msgs = dict(_parse_object_header(self._buf, addr))
        if _LAYOUT not in msgs:
            return self._read_group(addr)
        space = msgs[_DATASPACE]
        if space[0] != 2:
            raise ValueError("only version-2 dataspaces are supported")
        shape = struct.unpack_from(f"<{space[1]}Q", space, 4) if space[3] == 1 else ()
        dtype, _ = _decode_dtype(msgs[_DATATYPE], 0)
        layout = msgs[_LAYOUT]
        if layout[0] != 3 or layout[1] != 1:
            raise ValueError("only contiguous dataset layouts are supported")
        address, nbytes = struct.unpack_from("<QQ", layout, 2)
        return Dataset(self, shape, dtype, address, nbytes)
