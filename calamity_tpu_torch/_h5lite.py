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
fixed-length byte strings. h5py reads these files.

What it reads: every file the host layer reads through h5py, in numpy and
the standard library only, each value as h5py returns it (type, dtype,
shape and bits):
- superblocks 0 to 3; version-1 and version-2 object headers with their
  continuation blocks;
- old-style groups (symbol table: v1 B-tree, local heap, symbol nodes) and
  new-style groups with compact links or dense links (fractal heap and a
  v2 B-tree name index);
- dataspaces 1 and 2; datatypes of versions 1 to 3, either byte order:
  integers and floats (of any precision and offset: HDF5's conversion to
  the native type takes the value out, sign-extends it, and h5py's float
  of enough range and mantissa holds a float that is not IEEE's),
  fixed-length strings, booleans (h5py's enum), complex numbers (h5py's
  compound of r and i), every other compound of such members and of
  arrays of them (numpy's structured dtype, as h5py gives it: pyuvdata's
  integer visibilities), and variable-length strings (bytes, an object
  array of bytes for an array, from the global heap);
- compact, contiguous and chunked layouts: a v1 B-tree chunk index
  (layout 3) and the single-chunk, implicit, fixed-array, extensible-array
  (one unlimited dimension; paged data blocks, their pages never written
  read as the fill value) and v2 B-tree (more than one) indices (layout
  4), with edge chunks and unallocated chunks (read as the fill value);
- the deflate (``zlib``), shuffle, fletcher32, szip (CCSDS 121.0 adaptive
  Rice coding, as libaec writes it), n-bit, scale-offset (integers; floats
  by D-scale) and LZF (h5py's filter 32000) filters.
``read_direct`` converts as HDF5 does: into ``out``'s dtype chunk by chunk,
a compound member by member by name (into complex: r and i).

What raises ``ValueError`` naming what and where, none of it a file the JAX
package reads: the plugin filters (blosc, bitshuffle, lz4, zstd: h5py reads
them only through ``hdf5plugin``); scale-offset data at full precision
(HDF5 1.14 cannot read it back); variable-length sequences other than
strings, array, time, bitfield, opaque and reference datatypes (no field
the host layer reads holds one; an array only as a compound member);
filtered fractal heaps and huge or tiny heap objects (h5py puts these in
dense attribute storage or behind link names over 64 KiB). Opening a file
walks the links only; attributes are never read.

API: ``File(path, "r" | "w")`` as a context manager; groups support
``create_group``, ``create_dataset(name, data=...)``, ``group[name] =
value``, ``name in group``, ``group[name]`` and ``keys()``; datasets
support ``ds[()]`` (and other indexing, after a full read), ``shape``,
``dtype``, ``read_direct(out)`` (cast into ``out``'s dtype, chunk by
chunk) and ``np.asarray(ds)``.
"""

from __future__ import annotations

import mmap
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_SUPERBLOCK_SIZE = 48

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_VALUE, _LINK, _LAYOUT, _GROUP_INFO = (
    0x01, 0x02, 0x03, 0x05, 0x06, 0x08, 0x0A
)
_FILL_VALUE_OLD, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x04, 0x0B, 0x10, 0x11


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


def _padded8(n):
    return (n + 7) // 8 * 8


# (sign location, exponent location, exponent size, mantissa location,
# mantissa size, exponent bias) of the IEEE types numpy holds as they are
_IEEE = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127), 8: (63, 52, 11, 0, 52, 1023)}
_NP_FLOATS = (np.float16, np.float32, np.float64, np.longdouble)
# a variable-length element as stored: its length, then the global heap ID
_VLEN_RECORD = np.dtype([("length", "<u4"), ("collection", "<u8"), ("index", "<u4")])


class _Type:
    """A decoded datatype message: ``dtype``, the numpy dtype h5py returns;
    ``stored``, a numpy dtype that views the stored bytes; ``fix``, None
    where the two are the same values, else a function from an array of
    ``stored`` to one of ``dtype`` (HDF5's conversion to the native type:
    integers and floats whose precision, offset or fields are not numpy's);
    ``vlen``, True for a variable-length string (stored as
    ``_VLEN_RECORD``, read through the global heap)."""

    def __init__(self, dtype, stored=None, fix=None, vlen=False):
        self.dtype = np.dtype(dtype)
        self.stored = self.dtype if stored is None else np.dtype(stored)
        self.fix = fix
        self.vlen = vlen


def _unsigned(a, order):
    """The stored elements ``a`` (of 1, 2, 4 or 8 bytes) as unsigned
    integers (uint64) in byte order ``order``."""
    return a.view(f"{'>' if order == '>' else '<'}u{a.dtype.itemsize}").astype(np.uint64)


def _int_fix(dtype, precision, offset):
    """The values of an integer type whose ``precision`` bits start at bit
    ``offset``: the bits taken out, sign-extended where it is signed."""
    mask = np.uint64((1 << precision) - 1)

    def fix(a):
        v = (_unsigned(a, dtype.byteorder) >> np.uint64(offset)) & mask
        if dtype.kind == "i":
            v = v.astype(np.int64)
            v[v >= 1 << (precision - 1)] -= np.int64(1) << np.int64(precision)
        return v.astype(dtype)
    return fix


def _float_type(size, order, fields, bias, norm):
    """A float type numpy does not hold as it is stored: h5py returns the
    first of float16, 32, 64 and longdouble at least as wide that holds its
    mantissa and exponent range, and HDF5 converts each value exactly (a
    NaN to one with the same sign and every mantissa bit set)."""
    spos, epos, esize, mpos, msize = fields
    if norm != 2:
        raise ValueError(f"float datatype with mantissa normalization {norm} is not supported "
                         "(implied, as in IEEE, is)")
    if size not in (1, 2, 4, 8):
        raise ValueError(f"float datatype of {size} bytes is not supported")
    for cand in _NP_FLOATS:
        info = np.finfo(cand)
        if (np.dtype(cand).itemsize >= size and msize <= info.nmant
                and 2 ** esize - bias - 1 <= info.maxexp and 1 - bias >= info.minexp):
            break
    else:
        raise ValueError(f"float datatype {fields} with bias {bias} fits no numpy type")
    dtype = np.dtype(cand).newbyteorder(order)
    emax = (1 << esize) - 1

    def fix(a):
        u = _unsigned(a, order)
        sign = (u >> np.uint64(spos)) & np.uint64(1)
        e = ((u >> np.uint64(epos)) & np.uint64(emax)).astype(np.int64)
        m = (u >> np.uint64(mpos)) & np.uint64((1 << msize) - 1)
        normal = (e > 0) & (e < emax)
        whole = (m + np.where(normal, np.uint64(1 << msize), np.uint64(0))).astype(cand)
        v = np.ldexp(whole, (np.maximum(e, 1) - bias - msize).astype(np.int32))
        v[e == emax] = np.where(m[e == emax] == 0, np.inf, np.nan)
        v = np.where(sign == 1, -v, v)
        nan = (e == emax) & (m != 0)
        if nan.any() and v.dtype.itemsize <= 8:  # HDF5's NaN: every mantissa bit set
            ones = (1 << (8 * v.dtype.itemsize - 1)) - 1
            v.view(f"u{v.dtype.itemsize}")[nan] = np.where(sign[nan] == 1, 2 * ones + 1, ones)
        return v.astype(dtype)
    return _Type(dtype, np.dtype((np.void, size)), fix)


def _decode_dtype(buf, pos):
    """(``_Type``, position after the message) of a datatype message."""
    cls = buf[pos] & 0x0F
    version = buf[pos] >> 4
    bits = buf[pos + 1:pos + 4]
    size = struct.unpack_from("<I", buf, pos + 4)[0]
    p = pos + 8
    if cls in (0, 1):
        if cls == 1 and bits[0] & 0x40:
            raise ValueError("VAX-order floats are not supported")
        order = ">" if bits[0] & 0x01 else "<"
        offset, precision = struct.unpack_from("<HH", buf, p)
        if cls == 0:
            dtype = np.dtype(f"{order}{'i' if bits[0] & 0x08 else 'u'}{size}")
            if (offset, precision) == (0, 8 * size):
                return _Type(dtype), p + 4
            if size not in (1, 2, 4, 8):
                raise ValueError(f"integer datatype of {size} bytes is not supported")
            return _Type(dtype, fix=_int_fix(dtype, precision, offset)), p + 4
        epos, esize, mpos, msize, bias = struct.unpack_from("<BBBBI", buf, p + 4)
        fields = (bits[1], epos, esize, mpos, msize)
        norm = (bits[0] >> 4) & 0x03
        if (offset, precision, norm) == (0, 8 * size, 2) and _IEEE.get(size) == fields + (bias,):
            return _Type(f"{order}f{size}"), p + 12
        return _float_type(size, order, fields, bias, norm), p + 12
    if cls == 3:
        return _Type(f"S{size}"), p
    if cls == 6:
        return _compound_type(buf, p, version, bits, size)
    if cls == 8:
        nmembers = bits[0] | (bits[1] << 8)
        base, p = _decode_dtype(buf, p)
        names = []
        for _ in range(nmembers):
            end = buf.index(b"\x00", p)
            names.append(bytes(buf[p:end]))
            p = p + _padded8(end + 1 - p) if version < 3 else end + 1
        p += nmembers * base.dtype.itemsize
        if sorted(names) == [b"FALSE", b"TRUE"] and base.dtype.itemsize == 1:
            return _Type(bool), p
        return base, p
    if cls == 9 and bits[0] & 0x0F == 1:
        # a variable-length string: h5py gives bytes (objects), its metadata
        # naming str (UTF-8) or bytes (ASCII)
        _, p = _decode_dtype(buf, p)  # the base: one character
        vlen = str if (bits[1] & 0x0F) == 1 else bytes
        return _Type(np.dtype("O", metadata={"vlen": vlen}), _VLEN_RECORD, vlen=True), p
    if cls == 10 and version >= 2:
        rank = buf[p]
        p += 1 if version >= 3 else 4
        dims = struct.unpack_from(f"<{rank}I", buf, p)
        p += 4 * rank * (1 if version >= 3 else 2)  # version 2 adds permutation indices
        base, p = _decode_dtype(buf, p)
        return _array_type(base, dims), p
    kinds = {2: "time", 4: "bitfield", 5: "opaque", 7: "reference", 10: "array"}
    what = kinds.get(cls, f"class {cls}")
    if cls == 9:
        what = "variable-length sequence"
    raise ValueError(f"{what} datatype (version {version}) is not supported")


def _array_type(base, dims):
    if base.vlen or base.dtype.shape:
        raise ValueError("an array of variable-length or array elements is not supported")
    fix = None
    if base.fix is not None:
        def fix(a):
            return base.fix(a.reshape(-1)).reshape(a.shape)
    return _Type((base.dtype, tuple(dims)), (base.stored, tuple(dims)), fix)


def _compound_type(buf, p, version, bits, size):
    """A compound datatype: numpy complex for h5py's pair of one float type
    named r and i, else the structured dtype h5py returns (the file's
    member offsets and size)."""
    nmembers = bits[0] | (bits[1] << 8)
    offsize = max(1, (size.bit_length() + 7) // 8)
    names, offsets, types = [], [], []
    for _ in range(nmembers):
        end = buf.index(b"\x00", p)
        names.append(bytes(buf[p:end]).decode())
        dims = ()
        if version < 3:
            p += _padded8(end + 1 - p)
            offsets.append(struct.unpack_from("<I", buf, p)[0])
            if version == 1:  # dimensionality, reserved, permutation, reserved, 4 sizes
                dims = struct.unpack_from(f"<{buf[p + 4]}I", buf, p + 16)
                p += 28
            p += 4
        else:
            p = end + 1
            offsets.append(int.from_bytes(buf[p:p + offsize], "little"))
            p += offsize
        member, p = _decode_dtype(buf, p)
        if dims:
            member = _array_type(member, dims)
        if member.vlen:
            raise ValueError(f"compound member {names[-1]!r} of variable length is not supported")
        if member.dtype.itemsize != member.stored.itemsize:
            raise ValueError(f"compound member {names[-1]!r}: a {member.stored.itemsize}-byte "
                             f"float read as {member.dtype} is not supported")
        types.append(member)
    first = types[0].dtype if types else None
    if (names == ["r", "i"] and all(t.dtype == first and t.fix is None for t in types)
            and first.kind == "f" and offsets == [0, first.itemsize]
            and size == 2 * first.itemsize):
        return _Type(f"{first.byteorder.replace('=', '<')}c{size}"), p

    def struct_of(which):
        return np.dtype({"names": names, "formats": [getattr(t, which) for t in types],
                         "offsets": offsets, "itemsize": size})
    fix = None
    if any(t.fix is not None for t in types):
        def fix(a):
            out = np.empty(a.shape, struct_of("dtype"))
            for name, t in zip(names, types):
                out[name] = a[name] if t.fix is None else t.fix(a[name])
            return out
    return _Type(struct_of("dtype"), struct_of("stored"), fix), p


# ---------------------------------------------------------------------- #
# object headers and links
# ---------------------------------------------------------------------- #
def _object_header(messages):
    """Version-2 object header ("OHDR") holding ``messages``
    [(type, body), ...] in one chunk, with its checksum."""
    body = b"".join(struct.pack("<BHB", mtype, len(data), 0) + data for mtype, data in messages)
    head = b"OHDR" + bytes([2, 0x02]) + struct.pack("<I", len(body)) + body
    return head + struct.pack("<I", lookup3(head))


def _header_messages(buf, addr):
    """[(type, flags, body), ...] of the object header at ``addr``, version 1
    or 2, with the messages of its continuation blocks."""
    if bytes(buf[addr:addr + 4]) == b"OHDR":
        if buf[addr + 4] != 2:
            raise ValueError(f"object header version {buf[addr + 4]} at {addr} is not supported")
        flags = buf[addr + 5]
        p = addr + 6
        if flags & 0x20:
            p += 16  # access, modification, change and birth times
        if flags & 0x10:
            p += 4  # attribute phase-change values
        nsize = 1 << (flags & 0x03)
        size = int.from_bytes(buf[p:p + nsize], "little")
        p += nsize
        version, mhead = 2, 6 if flags & 0x04 else 4
    elif buf[addr] == 1:
        # version 1: a 16-byte prefix, then 8-byte-aligned messages
        size = struct.unpack_from("<I", buf, addr + 8)[0]
        p, version, mhead = addr + 16, 1, 8
    else:
        raise ValueError(f"no object header at {addr}")
    blocks = [(p, p + size)]
    msgs = []
    while blocks:
        p, end = blocks.pop(0)
        while p + mhead <= end:
            if version == 1:
                mtype, size, mflags = struct.unpack_from("<HHB", buf, p)
            else:
                mtype, size, mflags = buf[p], struct.unpack_from("<H", buf, p + 1)[0], buf[p + 3]
            p += mhead
            body = bytes(buf[p:p + size])
            p += size
            if mtype == _CONTINUATION:
                off, length = struct.unpack_from("<QQ", body)
                if version == 1:
                    blocks.append((off, off + length))
                elif bytes(buf[off:off + 4]) == b"OCHK":
                    blocks.append((off + 4, off + length - 4))  # signature, checksum
                else:
                    raise ValueError(f"no continuation block at {off}")
            elif mtype != 0:
                msgs.append((mtype, mflags, body))
    return msgs


def _decode_link(body):
    """(name, target) of a link message: the object header address of a hard
    link, or the reason another kind of link cannot be followed."""
    flags = body[1]
    p = 2
    ltype = 0
    if flags & 0x08:
        ltype = body[p]
        p += 1
    if flags & 0x04:
        p += 8  # creation order
    if flags & 0x10:
        p += 1  # character set
    nlen_size = 1 << (flags & 0x03)
    nlen = int.from_bytes(body[p:p + nlen_size], "little")
    p += nlen_size
    name = body[p:p + nlen].decode()
    if ltype != 0:
        kind = {1: "soft", 64: "external"}.get(ltype, f"type-{ltype}")
        return name, f"{kind} link {name!r} is not supported (only hard links)"
    return name, struct.unpack_from("<Q", body, p + nlen)[0]


def _enc_size(n):
    """Bytes HDF5 uses to store a count of at most ``n``."""
    return (max(int(n), 1).bit_length() - 1) // 8 + 1


def _cstr(buf, p):
    end = p
    while buf[end] != 0:
        end += 1
    return bytes(buf[p:end]).decode()


# ---------------------------------------------------------------------- #
# filters
# ---------------------------------------------------------------------- #
def _unshuffle(data, size):
    n = len(data) // size
    if size <= 1 or n <= 1:
        return data
    planes = np.frombuffer(data, np.uint8, count=n * size).reshape(size, n)
    return planes.T.tobytes() + data[n * size:]


def _fletcher32(data):
    """HDF5's Fletcher-32 checksum (``H5_checksum_fletcher32``): big-endian
    16-bit words, sums folded every 360 words."""
    words = np.frombuffer(data, ">u2", count=len(data) // 2).astype(np.int64)
    s1 = s2 = 0
    for i0 in range(0, len(words), 360):
        w = words[i0:i0 + 360]
        s2 += len(w) * s1 + int(np.dot(np.arange(len(w), 0, -1), w))
        s1 += int(w.sum())
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return (s2 << 16) | s1


def _lzf_decompress(data):
    """LZF (liblzf's format, h5py's filter 32000): runs of literals and
    back-references into the output."""
    out = bytearray()
    ip, n = 0, len(data)
    while ip < n:
        ctrl = data[ip]
        ip += 1
        if ctrl < 32:
            out += data[ip:ip + ctrl + 1]
            ip += ctrl + 1
            continue
        length = ctrl >> 5
        if length == 7:
            length += data[ip]
            ip += 1
        length += 2
        dist = ((ctrl & 0x1F) << 8) + data[ip] + 1
        ip += 1
        ref = len(out) - dist
        if ref < 0:
            raise ValueError("corrupt LZF data (back-reference before the start)")
        if dist >= length:
            out += out[ref:ref + length]
        else:  # the copy overlaps what it writes: the last dist bytes repeat
            out += (out[ref:] * (length // dist + 1))[:length]
    return bytes(out)


def _packed_values(stream, starts, nbits):
    """The ``nbits``-bit unsigned values (uint64, ``starts``' shape; at
    most 64 bits) that start at the bit positions ``starts`` of a byte
    stream read MSB first: each value from the 9 bytes from its first."""
    starts = np.asarray(starts, np.int64)
    if nbits == 0 or starts.size == 0:
        return np.zeros(starts.shape, np.uint64)
    if starts.max() + nbits > 8 * len(stream):
        raise ValueError("corrupt compressed data (the stream ends early)")
    padded = np.frombuffer(bytes(stream) + bytes(9), np.uint8)
    windows = np.lib.stride_tricks.sliding_window_view(padded, 9)[starts >> 3]
    head = np.ascontiguousarray(windows[..., :8]).view(">u8")[..., 0].astype(np.uint64)
    skip = (starts & 7).astype(np.uint64)
    word = (head << skip) | (windows[..., 8].astype(np.uint64) >> (np.uint64(8) - skip))
    return word >> np.uint64(64 - nbits)


def _gather_values(bits, starts, nbits):
    """The ``nbits``-bit unsigned values (uint64, ``starts``' shape) at the
    bit positions ``starts`` of an unpacked (MSB-first) bit array."""
    starts = np.asarray(starts, np.int64)
    if nbits == 0 or starts.size == 0:
        return np.zeros(starts.shape, np.uint64)
    where = starts[..., None] + np.arange(nbits, dtype=np.int64)
    if where.max() >= bits.size:
        raise ValueError("corrupt compressed data (the stream ends early)")
    weights = np.left_shift(np.uint64(1), np.arange(nbits - 1, -1, -1, dtype=np.uint64))
    return (bits[where].astype(np.uint64) * weights).sum(axis=-1, dtype=np.uint64)


# the second extension's pairs: code m -> beta = a + b and beta (beta + 1) / 2
_SE_BETA = np.array([i for i in range(13) for _ in range(i + 1)], np.int64)
_SE_MS = _SE_BETA * (_SE_BETA + 1) // 2
_ZERO, _SECOND, _RAW, _SPLIT = range(4)  # the kinds of a coded block
_NN_TABLES = {}


def _nn_step(x, d, xmax):
    """One step of the unit-delay predictor's inverse mapping: the sample
    after ``x`` whose mapped residual is ``d`` (integer arrays)."""
    half = (d >> 1) + (d & 1)
    low = x < xmax - x  # the predictor is nearer 0 than xmax
    theta = np.where(low, x, xmax - x)
    return np.where(half <= theta, x + np.where(d & 1, -half, d >> 1),
                    np.where(low, d, xmax - d))


def _nn_inverse(mapped, nbits):
    """The samples of intervals (rows of ``mapped``, each starting with its
    reference sample) whose other samples are the predictor's mapped
    residuals. A zero residual repeats the sample before it, so the
    recurrence steps only through the non-zero residuals: the t-th of every
    interval at once (8-bit samples take each step from a table), and each
    sample then takes the value at the last step at or before it."""
    xmax = (1 << nbits) - 1
    mapped = mapped.astype(np.int64)
    rows, cols = np.nonzero(mapped[:, 1:])
    cols += 1
    if rows.size == 0:
        return np.repeat(mapped[:, :1], mapped.shape[1], axis=1)
    counts = np.bincount(rows, minlength=len(mapped))
    step = np.arange(rows.size) - (np.cumsum(counts) - counts)[rows]  # t of each
    order = np.argsort(step, kind="stable")  # by t, then by interval
    bounds = np.concatenate([[0], np.cumsum(np.bincount(step))])
    table = _NN_TABLES.get(nbits)
    if nbits == 8 and table is None:
        grid = np.arange(256 * 256, dtype=np.int64)
        table = _NN_TABLES[nbits] = _nn_step(grid >> 8, grid & 255, xmax)
    x = mapped[:, 0].copy()
    d = mapped[rows, cols]
    value = np.empty(rows.size, np.int64)
    for t in range(len(bounds) - 1):
        idx = order[bounds[t]:bounds[t + 1]]
        r = rows[idx]
        x[r] = (table[(x[r] << 8) | d[idx]] if nbits == 8 else _nn_step(x[r], d[idx], xmax))
        value[idx] = x[r]
    known = np.zeros(mapped.shape, np.int64)  # the samples where a step lands
    known[:, 0] = mapped[:, 0]
    known[rows, cols] = value
    last = np.zeros(mapped.shape, np.int64)  # the column of the last step at or before
    last[rows, cols] = cols
    np.maximum.accumulate(last, axis=1, out=last)
    return np.take_along_axis(known, last, axis=1)


def _aec_decode(stream, nsamples, nbits, block, rsi, preprocess, seen=None):
    """CCSDS 121.0 adaptive Rice decoding as libaec implements it (the
    coder behind HDF5's szip filter): ``nsamples`` unsigned ``nbits``-bit
    samples (rounded up to whole reference sample intervals of ``rsi``
    blocks of ``block`` samples), every option: zero blocks, second
    extension, fundamental sequence and split samples, no compression; with
    ``preprocess`` the unit-delay predictor's mapped residuals, each
    interval starting with a reference sample, are mapped back. ``seen``, a
    set, collects the names of the options the stream used.

    Where each block starts in the stream depends on the blocks before it,
    so one loop walks the blocks, reading only their option and length: a
    block's fundamental-sequence codes end at the n-th one bit after it,
    found through the ranks of the stream's one bits. The samples of every
    block of a kind are then decoded together, in numpy."""
    bits = np.unpackbits(np.frombuffer(stream, np.uint8))
    nbits_total = bits.size
    ones = np.flatnonzero(bits)
    rank = np.zeros(nbits_total + 1, np.int64)  # one bits before each position
    np.cumsum(bits, out=rank[1:])
    id_len = 5 if nbits > 16 else 4 if nbits > 8 else 3
    id_raw = (1 << id_len) - 1
    ids = np.zeros(nbits_total, np.uint8)  # the id_len-bit value at each position
    padded = np.concatenate([bits, np.zeros(id_len, np.uint8)])
    for j in range(id_len):
        ids |= padded[j:j + nbits_total] << (id_len - 1 - j)
    per_rsi = rsi * block
    nrsi = -(-nsamples // per_rsi)
    m_ids, m_bits, m_rank, m_ones = (memoryview(x) for x in (ids, bits, rank, ones))
    blocks = []  # (start, kind, data position, ref, k) of each block that holds data
    pos = 0
    try:
        for r in range(nrsi):
            b = 0
            while b < rsi:
                ref = 1 if preprocess and b == 0 else 0
                opt = m_ids[pos]
                pos += id_len
                nblocks = 1
                if opt == 0:  # low entropy: zero blocks or the second extension
                    second = m_bits[pos]
                    pos += 1
                    data = pos
                    pos += ref * nbits
                    if second:  # block // 2 codes of a sample pair each
                        kind, pos = _SECOND, m_ones[m_rank[pos] + block // 2 - 1] + 1
                    else:
                        kind = _ZERO
                        end = m_ones[m_rank[pos]]
                        nblocks = end - pos + 1
                        pos = end + 1
                        if nblocks == 5:  # to the end of the interval or of its 64-block run
                            nblocks = min(rsi - b, 64 - b % 64)
                        elif nblocks > 5:
                            nblocks -= 1
                elif opt == id_raw:  # no compression: block samples of nbits each
                    kind, data = _RAW, pos
                    pos += block * nbits
                else:  # split samples: opt - 1 low bits under a fundamental sequence
                    kind, data = _SPLIT, pos
                    pos += ref * nbits
                    pos = m_ones[m_rank[pos] + block - ref - 1] + 1 + (block - ref) * (opt - 1)
                if kind != _ZERO or ref:
                    blocks.append((r * per_rsi + b * block, kind, data, ref, opt - 1))
                elif seen is not None:
                    seen.add("zero_block")
                b += nblocks
    except IndexError:
        raise ValueError("corrupt szip data (the stream ends early)") from None
    if pos > nbits_total:
        raise ValueError("corrupt szip data (the stream ends early)")
    start, kind, at, ref, k = np.asarray(blocks, np.int64).reshape(-1, 5).T
    if seen is not None:
        names = {_ZERO: "zero_block", _SECOND: "second_extension", _RAW: "no_compression"}
        for kd in np.unique(kind):
            if kd != _SPLIT:
                seen.add(names[int(kd)])
        split_k = k[kind == _SPLIT]
        if (split_k == 0).any():
            seen.add("fundamental_sequence")
        if (split_k > 0).any():
            seen.add("split_sample")
    out = np.zeros(nrsi * per_rsi, np.uint64)
    coded = (kind != _RAW) & (ref == 1)  # reference samples ahead of a coded block
    out[start[coded]] = _gather_values(bits, at[coded], nbits)
    raw = kind == _RAW
    if raw.any():
        lanes = np.arange(block, dtype=np.int64)
        out[start[raw, None] + lanes] = _gather_values(bits, at[raw, None] + lanes * nbits,
                                                       nbits)
    fs_at = at + ref * nbits  # where a coded block's fundamental sequences start

    def fs_values(sel, count, live=None):
        """The first ``count`` fundamental-sequence codes of the blocks
        ``sel``, (blocks, count), and where each ends (its one bit); only
        the codes where ``live`` (default all) are read."""
        idx = rank[fs_at[sel]][:, None] + np.arange(count, dtype=np.int64)
        if idx.size and (idx if live is None else idx[live]).max() >= ones.size:
            raise ValueError("corrupt szip data (the stream ends early)")
        ends = ones[np.minimum(idx, ones.size - 1)]
        prev = np.concatenate([fs_at[sel, None] - 1, ends[:, :-1]], axis=1)
        return ends - prev - 1, ends

    second = kind == _SECOND
    if second.any():
        m, _ = fs_values(second, block // 2)
        if m.max() >= len(_SE_BETA):
            raise ValueError("corrupt szip data (a second-extension code out of range)")
        d1 = m - _SE_MS[m]
        d0 = _SE_BETA[m] - d1
        o = start[second, None] + 2 * np.arange(block // 2, dtype=np.int64)
        out[o + 1] = d1
        keep = np.ones(d0.shape, bool)
        keep[:, 0] = ref[second] == 0  # the first pair's first sample is the reference
        out[o[keep]] = d0[keep]
    for kk in np.unique(k[kind == _SPLIT]):
        sel = (kind == _SPLIT) & (k == kk)
        n = block - ref[sel]  # coded samples of each block
        lanes = np.arange(block, dtype=np.int64)
        live = lanes < n[:, None]
        high, ends = fs_values(sel, block, live)
        low_at = ends[np.arange(len(n)), n - 1] + 1
        low = _gather_values(bits, low_at[:, None] + lanes * kk, int(kk))
        val = (high.astype(np.uint64) << np.uint64(kk)) | low
        o = start[sel, None] + ref[sel, None] + lanes
        out[o[live]] = val[live]
    if preprocess:  # the unit-delay predictor's mapping, undone interval by interval
        out = _nn_inverse(out.reshape(nrsi, per_rsi), nbits).astype(np.uint64).reshape(-1)
    return out[:nsamples]


def _szip_decompress(data, cd, seen=None):
    """HDF5's szip filter (libaec's szip interface): the uncompressed size
    (4 bytes), then the coded stream. ``cd``: the option mask (NN
    preprocessing 32, MSB byte order 16), pixels per block, bits per pixel,
    pixels per scanline. 32- and 64-bit pixels were coded as the byte
    planes of the chunk (its bytes interleaved by position in the word), 8
    bits a sample; scanlines are padded to whole blocks."""
    mask, ppb, bpp, pps = cd[:4]
    size = struct.unpack_from("<I", data)[0]
    interleave = bpp in (32, 64)
    nbits = 8 if interleave else bpp
    if nbits not in (8, 16):
        raise ValueError(f"szip with {bpp} bits per pixel is not supported (8, 16, 32, 64 are)")
    width = nbits // 8
    rsi = -(-pps // ppb)
    pad = rsi * ppb - pps
    count = size // width
    nscan = -(-count // pps)
    samples = _aec_decode(data[4:], nscan * rsi * ppb if pad else count, nbits, ppb, rsi,
                          bool(mask & 32), seen)
    if pad:  # each scanline's padding to whole blocks
        samples = samples.reshape(nscan, rsi * ppb)[:, :pps].reshape(-1)[:count]
    order = ">" if mask & 16 else "<"
    raw = samples.astype(f"{order}u{width}").tobytes()
    if interleave:  # byte planes back into words
        word = bpp // 8
        raw = np.frombuffer(raw, np.uint8).reshape(word, size // word).T.tobytes()
    return raw


def _scaleoffset_decompress(data, cd, dtype):
    """HDF5's scale-offset filter: minbits (4 bytes), the minimum's size (1
    byte) and value, then from byte 21 each element's offset from the
    minimum in minbits bits (MSB first). ``cd``: scale type (0 float
    D-scale, 2 integer), scale factor, elements, class (0 integer, 1
    float), size, sign, byte order, fill value defined, the fill value."""
    scale_type, scale_factor, nelmts, cls, size, sign, _, fill_defined = cd[:8]
    minbits = struct.unpack_from("<I", data)[0]
    minval = int.from_bytes(data[5:5 + min(8, data[4])], "little")
    kind = "f" if cls == 1 else ("i" if sign else "u")
    if minbits == 8 * size:
        raise ValueError("scale-offset data at full precision is not supported (HDF5 1.14 "
                         "does not read it back either)")
    if cls == 1 and scale_type != 0:
        raise ValueError(f"scale-offset type {scale_type} is not supported (D-scale is)")
    v = _packed_values(data[21:], np.arange(nelmts, dtype=np.int64) * minbits, minbits)
    words = np.frombuffer(struct.pack(f"<{len(cd) - 8}I", *cd[8:]), np.uint8)
    fill = words[:size].tobytes() if len(words) >= size else bytes(size)
    is_fill = (v == np.uint64((1 << minbits) - 1)) if fill_defined else np.zeros(nelmts, bool)
    if cls == 0:
        width = np.dtype(f"<u{size}")
        out = (v + np.uint64(minval)).astype(width)  # wraps at the type's width
        out[is_fill] = np.frombuffer(fill, width)[0]
        return out.view(f"<{kind}{size}").astype(dtype).tobytes()
    ftype = np.dtype(f"<f{size}")
    itype = np.int32 if size == 4 else np.int64
    scale = ftype.type(10.0 ** np.int32(np.uint32(scale_factor)))
    out = v.astype(itype).astype(ftype) / scale + np.frombuffer(
        minval.to_bytes(8, "little")[:size], ftype)[0]
    out[is_fill] = np.frombuffer(fill, ftype)[0]
    return out.astype(dtype).tobytes()


def _nbit_leaves(cd, i, base, out):
    """Walk the n-bit filter's class tree at ``cd[i]``: append to ``out``
    (byte offset in the element, size, big-endian, precision, offset) of
    each atomic value in the order the filter packs them, a no-op member's
    bytes as 8-bit values; return the index after the tree."""
    cls = cd[i]
    if cls == 1:  # atomic: size, byte order, precision, offset
        size, order, precision, offset = cd[i + 1:i + 5]
        out.append((base, size, order == 1, precision, offset))
        return i + 5
    if cls == 2:  # array: size, then the base class, once for each base element
        size, base_size, first = cd[i + 1], cd[i + 3], len(out)
        j = _nbit_leaves(cd, i + 2, base, out)
        one = out[first:]
        for k in range(1, size // base_size):
            out.extend((leaf[0] + k * base_size,) + leaf[1:] for leaf in one)
        return j
    if cls == 3:  # compound: size, members, then each member's offset and class
        j = i + 3
        for _ in range(cd[i + 2]):
            j = _nbit_leaves(cd, j + 1, base + cd[j], out)
        return j
    if cls == 4:  # no-op: size bytes copied as they are
        out.extend((base + k, 1, False, 8, 0) for k in range(cd[i + 1]))
        return i + 2
    raise ValueError(f"n-bit class {cls} is not known")


def _nbit_decompress(data, cd):
    """HDF5's n-bit filter: each element's significant bits (``precision``
    bits from bit ``offset`` of each atomic value, in the order of the
    class tree), packed MSB first with no gap between elements or values.
    The other bits read as zeros (the datatype's conversion then takes the
    value out of them). ``cd``: the number of client values, need-not-
    compress (the chunk was stored as it is), elements in the chunk, the
    class tree."""
    if cd[1]:
        return data
    leaves = []
    _nbit_leaves(cd, 3, 0, leaves)
    size = cd[4]  # the top class's size
    nelmts = cd[2]
    stride = sum(leaf[3] for leaf in leaves)
    out = np.zeros((nelmts, size), np.uint8)
    first = np.arange(nelmts, dtype=np.int64) * stride
    at = 0
    for offset, nbytes, big, precision, shift in leaves:
        if nbytes not in (1, 2, 4, 8) or precision + shift > 8 * nbytes:
            raise ValueError(f"n-bit value of {nbytes} bytes, precision {precision} at offset "
                             f"{shift} is not supported")
        v = _packed_values(data, first + at, precision) << np.uint64(shift)
        at += precision
        word = v.astype(f"{'>' if big else '<'}u{nbytes}")
        out[:, offset:offset + nbytes] = word.view(np.uint8).reshape(nelmts, nbytes)
    return out.tobytes()


_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 32000: "lzf", 32001: "blosc", 32004: "lz4",
                 32008: "bitshuffle", 32015: "zstd"}


def _decode_filters(body, where):
    """[(filter id, client data), ...] of a filter pipeline message, in the
    order they were applied; raises on a filter this reader cannot undo."""
    version, nfilters = body[0], body[1]
    p = 8 if version == 1 else 2
    out = []
    for _ in range(nfilters):
        fid = struct.unpack_from("<H", body, p)[0]
        p += 2
        nlen = 0
        if version == 1 or fid >= 256:
            nlen = struct.unpack_from("<H", body, p)[0]
            p += 2
        ncd = struct.unpack_from("<H", body, p + 2)[0]
        p += 4
        name = body[p:p + nlen].split(b"\x00")[0].decode(errors="replace")
        p += nlen
        cd = struct.unpack_from(f"<{ncd}I", body, p)
        p += 4 * ncd + (4 if version == 1 and ncd % 2 else 0)
        if fid not in (1, 2, 3, 4, 5, 6, 32000):
            label = _FILTER_NAMES.get(fid) or name or "unknown"
            raise ValueError(f"{where}: HDF5 filter {fid} ({label}) is not supported "
                             "(deflate, shuffle, fletcher32, szip, nbit, scaleoffset and lzf "
                             "are)")
        out.append((fid, cd))
    return out


# ---------------------------------------------------------------------- #
# datasets and groups
# ---------------------------------------------------------------------- #
class _DatasetInfo:
    """What reading a dataset needs, decoded from its object header."""

    def __init__(self, msgs, where):
        bodies = {}
        for mtype, mflags, body in msgs:
            if mflags & 0x02 and mtype in (_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS):
                raise ValueError(f"{where}: shared (committed) message {mtype} is not supported")
            bodies.setdefault(mtype, body)
        space = bodies[_DATASPACE]
        version, ndim, sflags = space[0], space[1], space[2]
        if version == 2 and space[3] == 2:
            raise ValueError(f"{where}: null dataspace is not supported")
        p = 8 if version == 1 else 4
        self.shape = tuple(struct.unpack_from(f"<{ndim}Q", space, p))
        self.maxshape = (tuple(struct.unpack_from(f"<{ndim}Q", space, p + 8 * ndim))
                         if sflags & 0x01 else self.shape)
        try:
            self.type, _ = _decode_dtype(bodies[_DATATYPE], 0)
        except ValueError as exc:
            raise ValueError(f"{where}: {exc}") from None
        self.dtype, self.stored = self.type.dtype, self.type.stored
        if self.dtype.shape:
            raise ValueError(f"{where}: array datatype {self.dtype} is not supported (only as a "
                             "compound member)")
        self.fill = self._fill_value(bodies)
        self.filters = _decode_filters(bodies[_FILTERS], where) if _FILTERS in bodies else []
        self.where = where
        self._layout(bodies[_LAYOUT])

    def _fill_value(self, bodies):
        raw = None
        if _FILL_VALUE in bodies:
            b = bodies[_FILL_VALUE]
            if b[0] in (1, 2) and (b[0] == 1 or b[3]) and len(b) >= 8:
                size = struct.unpack_from("<I", b, 4)[0]
                raw = b[8:8 + size]
            elif b[0] == 3 and b[1] & 0x20:
                size = struct.unpack_from("<I", b, 2)[0]
                raw = b[6:6 + size]
        elif _FILL_VALUE_OLD in bodies:
            b = bodies[_FILL_VALUE_OLD]
            raw = b[4:4 + struct.unpack_from("<I", b, 0)[0]]
        if raw and len(raw) == self.stored.itemsize:  # as stored: read as the elements are
            return np.frombuffer(raw, self.stored, count=1).reshape(())
        return np.zeros((), self.stored)

    def _layout(self, lay):
        version, cls = lay[0], lay[1]
        if version not in (3, 4):
            raise ValueError(f"{self.where}: data layout version {version} is not supported")
        self.kind = {0: "compact", 1: "contiguous", 2: "chunked"}.get(cls)
        if cls == 0:
            size = struct.unpack_from("<H", lay, 2)[0]
            self.raw = lay[4:4 + size]
        elif cls == 1:
            self.address, self.size = struct.unpack_from("<QQ", lay, 2)
        elif cls == 2 and version == 3:
            ndims = lay[2]
            self.address = struct.unpack_from("<Q", lay, 3)[0]
            dims = struct.unpack_from(f"<{ndims}I", lay, 11)
            self.chunk, self.index = tuple(dims[:-1]), "btree1"
            self.edge_unfiltered = False
        elif cls == 2:
            flags, ndims, enc = lay[2], lay[3], lay[4]
            p = 5
            dims = [int.from_bytes(lay[p + i * enc:p + (i + 1) * enc], "little")
                    for i in range(ndims)]
            p += ndims * enc
            self.chunk = tuple(dims[:-1])
            self.edge_unfiltered = bool(flags & 0x01)
            itype = lay[p]
            p += 1
            self.index = {1: "single", 2: "implicit", 3: "fixed_array", 4: "extensible_array",
                          5: "btree2"}.get(itype)
            if self.index is None:
                raise ValueError(f"{self.where}: chunk index type {itype} is not supported")
            self.single_filtered = None
            if itype == 1 and flags & 0x02:
                self.single_filtered = struct.unpack_from("<QI", lay, p)
                p += 12
            # the index's creation parameters: fixed array page bits;
            # extensible array max bits, index elements, min pointers, min
            # elements, page bits; v2 B-tree node size, split and merge
            p += {3: 1, 4: 5, 5: 6}.get(itype, 0)
            self.address = struct.unpack_from("<Q", lay, p)[0]
        else:
            raise ValueError(f"{self.where}: layout class {cls} is not supported")


class Dataset:
    """A dataset of a file opened for reading; decoded when first used."""

    def __init__(self, file, name, msgs):
        self._file = file
        self.name = name
        self._msgs = msgs
        self._meta = None

    def _info(self):
        if self._meta is None:
            self._meta = _DatasetInfo(self._msgs, f"dataset {self.name!r}")
        return self._meta

    @property
    def shape(self):
        return self._info().shape

    @property
    def dtype(self):
        return self._info().dtype

    def _read(self):
        out = np.empty(self.shape, dtype=self.dtype)
        self.read_direct(out)
        return out

    def __getitem__(self, key):
        return self._read()[key]

    def __array__(self, dtype=None, copy=None):
        arr = self._read()
        return arr if dtype is None else arr.astype(dtype)

    def read_direct(self, out):
        """Read the whole dataset into ``out`` (its shape), cast to
        ``out``'s dtype; a chunked dataset chunk by chunk."""
        info = self._info()
        if tuple(out.shape) != info.shape:
            raise ValueError(f"{info.where}: out has shape {out.shape}, dataset {info.shape}")
        self._file._read_into(info, out)

    def __len__(self):
        return self.shape[0]


class _WrittenDataset:
    """A dataset written to a file opened for writing."""

    def __init__(self, shape, dtype, header):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._header = header


class Group:
    """A group: named children, each a Group or a Dataset (resolved from
    its object header when first used, in a file opened for reading)."""

    def __init__(self, file, name="/"):
        self._file = file
        self.name = name
        self._children = {}

    def __contains__(self, name):
        return name in self._children

    def __getitem__(self, name):
        node = self
        for part in name.strip("/").split("/"):
            node = node._child(part)
        return node

    def _child(self, part):
        child = self._children[part]
        if isinstance(child, str):
            raise ValueError(f"{self.name.rstrip('/')}/{part}: {child}")
        if isinstance(child, int):
            child = self._file._node(child, f"{self.name.rstrip('/')}/{part}")
            self._children[part] = child
        return child

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
        self._views = []
        if mode == "w":
            self._fh = open(path, "wb")
            self._fh.write(bytes(_SUPERBLOCK_SIZE))
        elif mode == "r":
            self._fh = open(path, "rb")
            self._map = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
            self._heaps = {}
            self._buf = memoryview(self._map)
            self._views.append(self._buf)
            try:
                self._load()
            except BaseException:
                self.close()
                raise
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
        return _WrittenDataset(arr.shape, arr.dtype, self._append(header))

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
        else:
            try:
                for view in reversed(self._views):
                    view.release()
            except BufferError:  # an array still views the map; it closes with the array
                pass
            self._views = []
            try:
                self._map.close()
            except BufferError:  # an array still views the map; it closes with the array
                pass
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
        sb = 0
        while bytes(buf[sb:sb + 8]) != _SIGNATURE:
            sb = 512 if sb == 0 else 2 * sb  # a user block pushes the superblock to 512 * 2^k
            if sb + 8 > len(buf):
                raise ValueError(f"{self._path}: not an HDF5 file")
        version = buf[sb + 8]
        if version in (0, 1):
            sizes = (buf[sb + 13], buf[sb + 14])
            p = sb + 24 + (4 if version == 1 else 0)
            base = struct.unpack_from("<Q", buf, p)[0]
            root = struct.unpack_from("<Q", buf, p + 32 + 8)[0]  # the root's symbol table entry
        elif version in (2, 3):
            sizes = (buf[sb + 9], buf[sb + 10])
            base, root = struct.unpack_from("<Q", buf, sb + 12)[0], struct.unpack_from(
                "<Q", buf, sb + 36)[0]
        else:
            raise ValueError(f"{self._path}: superblock version {version} is not supported")
        if sizes != (8, 8):
            raise ValueError(f"{self._path}: only 8-byte offsets and lengths are supported")
        if base:
            self._buf = buf[base:]  # every address is relative to the base address
            self._views.append(self._buf)
        self._children = self._links(root, where="group '/'")

    def _node(self, addr, name):
        msgs = _header_messages(self._buf, addr)
        if any(m[0] == _LAYOUT for m in msgs):
            return Dataset(self, name, msgs)
        grp = Group(self, name)
        grp._children = self._links(addr, msgs, f"group {name!r}")
        return grp

    def _links(self, addr, msgs=None, where=""):
        """{name: object header address} of the group at ``addr``
        (``where`` names it in an error)."""
        links = {}
        for mtype, _, body in msgs or _header_messages(self._buf, addr):
            if mtype == _LINK:
                name, target = _decode_link(body)
                links[name] = target
            elif mtype == _SYMBOL_TABLE:
                links.update(self._symbol_table(*struct.unpack_from("<QQ", body)))
            elif mtype == _LINK_INFO:
                try:
                    links.update(self._dense_links(body))
                except ValueError as exc:
                    raise ValueError(f"{where}: {exc}") from None
        return links

    def _btree1(self, addr, key_size):
        """[(key, child address), ...] of the leaves of the v1 B-tree at
        ``addr``."""
        buf = self._buf
        out, todo = [], [addr]
        while todo:
            a = todo.pop()
            if bytes(buf[a:a + 4]) != b"TREE":
                raise ValueError(f"no v1 B-tree node at {a}")
            level, n = buf[a + 5], struct.unpack_from("<H", buf, a + 6)[0]
            p = a + 24
            for _ in range(n):
                key = bytes(buf[p:p + key_size])
                child = struct.unpack_from("<Q", buf, p + key_size)[0]
                p += key_size + 8
                if level == 0:
                    out.append((key, child))
                else:
                    todo.append(child)
        return out

    def _symbol_table(self, btree, heap):
        """An old-style group: symbol nodes under a v1 B-tree, names in a
        local heap."""
        buf = self._buf
        if bytes(buf[heap:heap + 4]) != b"HEAP":
            raise ValueError(f"no local heap at {heap}")
        names = struct.unpack_from("<Q", buf, heap + 24)[0]
        links = {}
        for _, snod in self._btree1(btree, 8):
            if bytes(buf[snod:snod + 4]) != b"SNOD":
                raise ValueError(f"no symbol table node at {snod}")
            p = snod + 8
            for _ in range(struct.unpack_from("<H", buf, snod + 6)[0]):
                name_off, obj = struct.unpack_from("<QQ", buf, p)
                links[_cstr(buf, names + name_off)] = obj
                p += 40
        return links

    def _dense_links(self, body):
        """A new-style group's links held in a fractal heap, indexed by
        name hash in a v2 B-tree (records of type 5)."""
        p = 2 + (8 if body[1] & 0x01 else 0)
        heap, index = struct.unpack_from("<QQ", body, p)
        if heap == _UNDEF:
            return {}
        hdr = self._fractal_heap(heap)
        links = {}
        for rec in self._btree2_records(index):
            name, target = _decode_link(self._heap_object(hdr, rec[4:]))
            links[name] = target
        return links

    def _fractal_heap(self, addr):
        buf = self._buf
        if bytes(buf[addr:addr + 4]) != b"FRHP":
            raise ValueError(f"no fractal heap at {addr}")
        if struct.unpack_from("<H", buf, addr + 7)[0]:
            raise ValueError(f"fractal heap at {addr}: I/O filters are not supported")
        width = struct.unpack_from("<H", buf, addr + 110)[0]
        start, max_direct = struct.unpack_from("<QQ", buf, addr + 112)
        max_bits = struct.unpack_from("<H", buf, addr + 128)[0]
        root = struct.unpack_from("<Q", buf, addr + 132)[0]
        rows = struct.unpack_from("<H", buf, addr + 140)[0]
        max_managed = struct.unpack_from("<I", buf, addr + 10)[0]
        return {
            "width": width, "start": start, "max_direct": max_direct, "root": root,
            "rows": rows, "off_size": (max_bits + 7) // 8,
            "len_size": min((max_direct.bit_length() - 1 + 7) // 8, _enc_size(max_managed)),
            # rows of direct blocks in an indirect block
            "direct_rows": (max_direct.bit_length() - start.bit_length()) + 2,
            "first_row_bits": (start.bit_length() - 1) + (width.bit_length() - 1),
        }

    def _heap_object(self, hdr, heap_id):
        if (heap_id[0] >> 4) & 0x03:
            raise ValueError("huge and tiny fractal heap objects (links over 64 KiB or of a "
                             "few bytes) are not supported")
        osz, lsz = hdr["off_size"], hdr["len_size"]
        off = int.from_bytes(heap_id[1:1 + osz], "little")
        length = int.from_bytes(heap_id[1 + osz:1 + osz + lsz], "little")
        if hdr["rows"] == 0:  # the root is one direct block
            addr = hdr["root"] + off
        else:
            addr = self._heap_locate(hdr, hdr["root"], hdr["rows"], 0, off)
        return bytes(self._buf[addr:addr + length])

    def _heap_locate(self, hdr, iblock, nrows, block_off, off):
        """File address of heap offset ``off`` under the indirect block at
        ``iblock`` (``nrows`` rows, starting at heap offset ``block_off``)."""
        if bytes(self._buf[iblock:iblock + 4]) != b"FHIB":
            raise ValueError(f"no fractal heap indirect block at {iblock}")
        p = iblock + 13 + hdr["off_size"]
        pos = block_off
        for row in range(nrows):
            size = hdr["start"] << max(0, row - 1)
            for _ in range(hdr["width"]):
                child = struct.unpack_from("<Q", self._buf, p)[0]
                p += 8
                if pos <= off < pos + size and child != _UNDEF:
                    if row < hdr["direct_rows"]:
                        return child + (off - pos)
                    child_rows = (size.bit_length() - 1) - hdr["first_row_bits"] + 1
                    return self._heap_locate(hdr, child, child_rows, pos, off)
                pos += size
        raise ValueError(f"heap offset {off} is not in the fractal heap")

    def _btree2_records(self, addr):
        """Every record of the v2 B-tree at ``addr``."""
        buf = self._buf
        if bytes(buf[addr:addr + 4]) != b"BTHD":
            raise ValueError(f"no v2 B-tree header at {addr}")
        node_size = struct.unpack_from("<I", buf, addr + 6)[0]
        rec_size, depth = struct.unpack_from("<HH", buf, addr + 10)
        root, root_nrec = struct.unpack_from("<QH", buf, addr + 16)
        # the sizes of the record counts in internal nodes (H5B2 node info)
        max_nrec = [(node_size - 10) // rec_size]
        cum = [max_nrec[0]]
        cum_size = [0]
        nrec_size = _enc_size(max_nrec[0])
        for d in range(1, depth + 1):
            ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            m = (node_size - (10 + ptr)) // (rec_size + ptr)
            cum.append((m + 1) * cum[d - 1] + m)
            cum_size.append(_enc_size(cum[d]))
        records = []

        def visit(a, nrec, d):
            if bytes(buf[a:a + 4]) != (b"BTLF" if d == 0 else b"BTIN"):
                raise ValueError(f"no v2 B-tree node at {a}")
            p = a + 6
            records.extend(bytes(buf[p + i * rec_size:p + (i + 1) * rec_size])
                           for i in range(nrec))
            p += nrec * rec_size
            for _ in range(nrec + 1 if d else 0):
                child = struct.unpack_from("<Q", buf, p)[0]
                n = int.from_bytes(buf[p + 8:p + 8 + nrec_size], "little")
                p += 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
                visit(child, n, d - 1)

        if root != _UNDEF and root_nrec:
            visit(root, root_nrec, depth)
        return records

    # -- dataset storage ------------------------------------------------- #
    def _read_into(self, info, out):
        count = int(np.prod(info.shape, dtype=np.int64))
        if count == 0:
            return
        if info.kind == "compact":
            self._store(info, out, np.frombuffer(info.raw, info.stored,
                                                 count=count).reshape(info.shape))
        elif info.kind == "contiguous":
            if info.address == _UNDEF:
                self._store(info, out, info.fill)
                return
            arr = np.frombuffer(self._buf, info.stored, count=count, offset=info.address)
            self._store(info, out, arr.reshape(info.shape))
            del arr
        else:
            self._read_chunked(info, out)

    def _store(self, info, dst, arr):
        """Write the stored elements ``arr`` into ``dst`` as HDF5 converts
        them: to the dataset's values (``_Type.fix``; a variable-length
        string from the global heap), then to ``dst``'s type, compound
        members by name (into complex: r and i)."""
        if info.type.vlen:
            arr = self._vlen_strings(arr, info.where)
        elif info.type.fix is not None:
            arr = info.type.fix(arr)
        names = arr.dtype.names
        if names and dst.dtype.kind == "c":
            if not {"r", "i"} <= set(names):
                raise ValueError(f"{info.where}: compound {list(names)} has no members r and i "
                                 f"to read into {dst.dtype}")
            dst.real[...] = arr["r"]
            dst.imag[...] = arr["i"]
        elif names and dst.dtype.names and dst.dtype != arr.dtype:
            for name in dst.dtype.names:
                dst[name] = arr[name]
        else:
            dst[...] = arr

    def _vlen_strings(self, records, where):
        """The bytes of variable-length strings (``_VLEN_RECORD`` each: the
        length, and the global heap collection and object that hold them);
        an element never written reads as b"". h5py reads them as C
        strings, so they end at a zero byte."""
        flat = records.reshape(-1)
        out = np.empty(flat.shape, object)
        for k, (length, collection, index) in enumerate(flat.tolist()):
            if length == 0 or collection in (0, _UNDEF):
                out[k] = b""
                continue
            heap = self._global_heap(collection)
            if index not in heap:
                raise ValueError(f"{where}: object {index} is not in the global heap at "
                                 f"{collection}")
            out[k] = heap[index][:length].split(b"\x00")[0]
        return out.reshape(records.shape)

    def _global_heap(self, addr):
        """{object index: bytes} of the global heap collection at ``addr``:
        after its 16-byte head, objects of an index (2 bytes), a reference
        count (2), 4 reserved bytes, a size (8) and the data padded to 8
        bytes, up to the free space (index 0)."""
        heap = self._heaps.get(addr)
        if heap is None:
            buf = self._buf
            if bytes(buf[addr:addr + 4]) != b"GCOL":
                raise ValueError(f"no global heap collection at {addr}")
            end = addr + struct.unpack_from("<Q", buf, addr + 8)[0]
            heap, p = {}, addr + 16
            while p + 16 <= end:
                index, size = struct.unpack_from("<H", buf, p)[0], struct.unpack_from(
                    "<Q", buf, p + 8)[0]
                if index == 0:
                    break
                heap[index] = bytes(buf[p + 16:p + 16 + size])
                p += 16 + _padded8(size)
            self._heaps[addr] = heap
        return heap

    def _chunks(self, info):
        """[(element offsets, address, stored size, filter mask), ...] of the
        allocated chunks of a chunked dataset."""
        rank = len(info.shape)
        full = int(np.prod(info.chunk, dtype=np.int64)) * info.stored.itemsize
        grid = [-(-m // c) for m, c in zip(info.maxshape, info.chunk)]

        def offsets(k):  # the k-th chunk of the grid, in row-major order
            return tuple(int(i) * c for i, c in zip(np.unravel_index(k, grid), info.chunk))

        if info.address == _UNDEF:
            return []
        if info.index == "btree1":
            out = []
            for key, addr in self._btree1(info.address, 8 + 8 * (rank + 1)):
                size, mask = struct.unpack_from("<II", key)
                out.append((struct.unpack_from(f"<{rank}Q", key, 8), addr, size, mask))
            return out
        if info.index == "single":
            size, mask = info.single_filtered or (full, 0)
            return [((0,) * rank, info.address, size, mask)]
        if info.index == "implicit":
            return [(offsets(k), info.address + k * full, full, 0)
                    for k in range(int(np.prod(grid)))]
        if info.index == "extensible_array":
            return self._extensible_array_chunks(info, full)
        if info.index == "btree2":
            return self._btree2_chunks(info, full)
        return self._fixed_array_chunks(info, full, offsets)

    def _btree2_chunks(self, info, full):
        """The chunks of a v2 B-tree chunk index (datasets with more than one
        unlimited dimension): records of type 10 (address, scaled offsets)
        or 11 (address, stored size, filter mask, scaled offsets)."""
        buf = self._buf
        a = info.address
        if bytes(buf[a:a + 4]) != b"BTHD":
            raise ValueError(f"{info.where}: no v2 B-tree header at {a}")
        rtype, rec_size = buf[a + 5], struct.unpack_from("<H", buf, a + 10)[0]
        if rtype not in (10, 11):
            raise ValueError(f"{info.where}: v2 B-tree record type {rtype} is not a chunk record")
        rank = len(info.shape)
        size_len = rec_size - 8 - 8 * rank - 4  # the stored size of a filtered chunk
        out = []
        for rec in self._btree2_records(a):
            addr = struct.unpack_from("<Q", rec, 0)[0]
            size, mask, p = full, 0, 8
            if rtype == 11:
                size = int.from_bytes(rec[8:8 + size_len], "little")
                mask = struct.unpack_from("<I", rec, 8 + size_len)[0]
                p = 12 + size_len
            scaled = struct.unpack_from(f"<{rank}Q", rec, p)
            if addr != _UNDEF:
                offset = tuple(int(k) * c for k, c in zip(scaled, info.chunk))
                out.append((offset, addr, size, mask))
        return out

    def _extensible_array_chunks(self, info, full):
        """The chunks of an extensible-array chunk index (datasets with one
        unlimited dimension): its header, index block, data blocks and
        secondary blocks; elements are addresses, or (address, stored
        size, filter mask) for filtered chunks. Element k is the k-th chunk
        of the grid in row-major order with the unlimited dimension moved
        first (the others span the maximum shape)."""
        buf = self._buf
        a = info.address
        if bytes(buf[a:a + 4]) != b"EAHD":
            raise ValueError(f"{info.where}: no extensible-array header at {a}")
        filtered, esize, max_bits, iblk_n, dblk_min, sblk_min_ptrs, page_bits = buf[a + 5:a + 12]
        nset = struct.unpack_from("<Q", buf, a + 44)[0]  # one past the largest index set
        iblock = struct.unpack_from("<Q", buf, a + 60)[0]
        if nset == 0 or iblock == _UNDEF:
            return []
        off_size = (max_bits + 7) // 8  # a block's offset in the array's index space
        size_len = esize - 12

        def element(q):
            addr = struct.unpack_from("<Q", buf, q)[0]
            if not filtered:
                return addr, full, 0
            return (addr, int.from_bytes(buf[q + 8:q + 8 + size_len], "little"),
                    struct.unpack_from("<I", buf, q + 8 + size_len)[0])

        def block(addr, magic, what):
            if bytes(buf[addr:addr + 4]) != magic:
                raise ValueError(f"{info.where}: no extensible-array {what} at {addr}")
            return addr + 14  # signature, version, client, header address

        elements = []  # (index, element address)
        p = block(iblock, b"EAIB", "index block")
        elements += [(k, p + k * esize) for k in range(min(iblk_n, nset))]
        p += iblk_n * esize
        # super blocks: ndblks data blocks of dblk_n elements each
        nsblks = 1 + max_bits - (dblk_min.bit_length() - 1)
        sblk_info, start = [], iblk_n
        for u in range(nsblks):
            ndblks, dblk_n = 1 << (u // 2), (1 << ((u + 1) // 2)) * dblk_min
            sblk_info.append((ndblks, dblk_n, start))
            start += ndblks * dblk_n
        iblk_sblks = 2 * (sblk_min_ptrs.bit_length() - 1)  # super blocks with direct pointers
        ndblk_addrs = 2 * (sblk_min_ptrs - 1)
        dblk_addrs = struct.unpack_from(f"<{ndblk_addrs}Q", buf, p)
        sblk_addrs = struct.unpack_from(f"<{nsblks - iblk_sblks}Q", buf, p + 8 * ndblk_addrs)
        page = 1 << page_bits

        def data_block(addr, first, dblk_n, pages=None):
            """The elements of a data block; a paged one (more than
            ``page`` elements) holds none itself: after its checksum come
            its pages, each of ``page`` elements and a checksum, of which
            only those ``pages`` marks initialised were written."""
            if addr == _UNDEF or first >= nset:
                return
            q = block(addr, b"EADB", "data block") + off_size
            if dblk_n <= page:
                elements.extend((first + k, q + k * esize)
                                for k in range(min(dblk_n, nset - first)))
                return
            if pages is None:
                raise ValueError(f"{info.where}: a paged extensible-array data block in the index "
                                 "block is not supported")
            q += 4
            for pg, written in enumerate(pages):
                k0 = pg * page
                if written and first + k0 < nset:
                    at = q + pg * (page * esize + 4)
                    elements.extend((first + k0 + k, at + k * esize)
                                    for k in range(min(page, nset - first - k0)))

        d = 0
        for u in range(min(iblk_sblks, nsblks)):
            ndblks, dblk_n, first = sblk_info[u]
            for k in range(ndblks):
                data_block(dblk_addrs[d], first + k * dblk_n, dblk_n)
                d += 1
        for u in range(iblk_sblks, nsblks):
            ndblks, dblk_n, first = sblk_info[u]
            sb = sblk_addrs[u - iblk_sblks]
            if sb == _UNDEF or first >= nset:
                continue
            q = block(sb, b"EASB", "secondary block") + off_size
            # which pages are initialised: one bit a page, MSB first, data block after
            # data block, in whole bytes for each data block
            npages = dblk_n // page if dblk_n > page else 0
            bitmap = bytes(buf[q:q + ndblks * ((npages + 7) // 8)])
            q += len(bitmap)
            for k, addr in enumerate(struct.unpack_from(f"<{ndblks}Q", buf, q)):
                pages = [bitmap[b // 8] & (0x80 >> (b % 8))
                         for b in range(k * npages, (k + 1) * npages)] if npages else None
                data_block(addr, first + k * dblk_n, dblk_n, pages)
        # element index -> chunk offsets: the unlimited dimension first
        unlim = [d for d, m in enumerate(info.maxshape) if m == _UNDEF]
        if len(unlim) != 1:
            raise ValueError(f"{info.where}: an extensible-array index with {len(unlim)} "
                             "unlimited dimensions")
        order = unlim + [d for d in range(len(info.shape)) if d != unlim[0]]
        grid = [-(-info.maxshape[d] // info.chunk[d]) for d in order[1:]]
        out = []
        for k, q in elements:
            addr, size, mask = element(q)
            if addr == _UNDEF:
                continue
            scaled = (k // max(int(np.prod(grid)), 1),) + tuple(
                int(i) for i in np.unravel_index(k % max(int(np.prod(grid)), 1), grid))
            offs = [0] * len(order)
            for d, i in zip(order, scaled):
                offs[d] = i * info.chunk[d]
            out.append((tuple(offs), addr, size, mask))
        return out

    def _fixed_array_chunks(self, info, full, offsets):
        buf = self._buf
        a = info.address
        if bytes(buf[a:a + 4]) != b"FAHD":
            raise ValueError(f"{info.where}: no fixed-array header at {a}")
        filtered, entry, page_bits = buf[a + 5], buf[a + 6], buf[a + 7]
        nelem, dblock = struct.unpack_from("<QQ", buf, a + 8)
        if bytes(buf[dblock:dblock + 4]) != b"FADB":
            raise ValueError(f"{info.where}: no fixed-array data block at {dblock}")
        p = dblock + 14
        page = 1 << page_bits
        if nelem > page:  # paged: an init bitmap, then pages of entries, each with a checksum
            npages = -(-nelem // page)
            bitmap = bytes(buf[p:p + (npages + 7) // 8])
            first = p + len(bitmap) + 4
            spans = []
            for k in range(npages):
                n = min(page, nelem - k * page)
                if bitmap[k // 8] & (0x80 >> (k % 8)):
                    spans.append((first, k * page, n))
                first += page * entry + 4
        else:
            spans = [(p, 0, nelem)]
        out = []
        for start, k0, n in spans:
            for i in range(n):
                q = start + i * entry
                addr = struct.unpack_from("<Q", buf, q)[0]
                if addr == _UNDEF:
                    continue
                size, mask = full, 0
                if filtered:
                    size = int.from_bytes(buf[q + 8:q + entry - 4], "little")
                    mask = struct.unpack_from("<I", buf, q + entry - 4)[0]
                out.append((offsets(k0 + i), addr, size, mask))
        return out

    def _chunk_data(self, info, addr, size, mask, partial):
        data = bytes(self._buf[addr:addr + size])
        if partial and info.edge_unfiltered:
            return data
        try:
            return self._unfilter(info, data, mask, addr)
        except ValueError as exc:
            raise ValueError(f"{info.where}: {exc}") from None

    def _unfilter(self, info, data, mask, addr):
        """Undo the filters of a chunk's pipeline (those ``mask`` did not
        skip), last first."""
        for i in reversed(range(len(info.filters))):
            if mask & (1 << i):
                continue
            fid, cd = info.filters[i]
            if fid == 1:
                data = zlib.decompress(data)
            elif fid == 2:
                data = _unshuffle(data, cd[0] if cd else info.stored.itemsize)
            elif fid == 3:
                stored = data[-4:]
                data = data[:-4]
                want = _fletcher32(data).to_bytes(4, "little")
                if stored not in (want, bytes([want[1], want[0], want[3], want[2]])):
                    raise ValueError(f"fletcher32 checksum mismatch in the chunk at {addr}")
            elif fid == 4:
                data = _szip_decompress(data, cd)
            elif fid == 5:
                data = _nbit_decompress(data, cd)
            elif fid == 6:
                data = _scaleoffset_decompress(data, cd, info.stored)
            else:
                data = _lzf_decompress(data)
        return data

    def _read_chunked(self, info, out):
        chunk = info.chunk
        ccount = int(np.prod(chunk, dtype=np.int64))
        nchunks = int(np.prod([-(-s // c) for s, c in zip(info.shape, chunk)]))
        chunks = [c for c in self._chunks(info)
                  if all(o < s for o, s in zip(c[0], info.shape))]
        if len(chunks) < nchunks:  # unallocated chunks read as the fill value
            self._store(info, out, info.fill)
        for offs, addr, size, mask in chunks:
            ends = [min(o + c, s) for o, c, s in zip(offs, chunk, info.shape)]
            partial = any(e - o < c for o, e, c in zip(offs, ends, chunk))
            data = self._chunk_data(info, addr, size, mask, partial)
            if len(data) < ccount * info.stored.itemsize:
                raise ValueError(f"{info.where}: chunk at {addr} decodes to {len(data)} bytes, "
                                 f"expected {ccount * info.stored.itemsize}")
            arr = np.frombuffer(data, info.stored, count=ccount).reshape(chunk)
            self._store(info, out[tuple(slice(o, e) for o, e in zip(offs, ends))],
                        arr[tuple(slice(0, e - o) for o, e in zip(offs, ends))])
