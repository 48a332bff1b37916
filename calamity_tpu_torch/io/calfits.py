"""pyuvdata-compatible calfits reader/writer (pure numpy, no astropy).

The reference persists gains with ``UVCal.write_calfits``
(reference calibration.py:1810), producing the "calfits" FITS convention
the HERA toolchain consumes. This module emits that exact layout so files
written here are readable by pyuvdata and vice versa:

  Primary HDU (gain type)
      float64 data cube, FITS axes (fastest..slowest):
        NAXIS1 = 4        data arrays: gain.real, gain.imag, flag, quality
        NAXIS2 = Njones   CTYPE2 'JONES'   (AIPS integers via CRVAL/CDELT)
        NAXIS3 = Ntimes   CTYPE3 'TIME'    (JD via CRVAL/CDELT)
        NAXIS4 = Nfreqs   CTYPE4 'FREQS'   (Hz via CRVAL/CDELT)
        NAXIS5 = Nspws    CTYPE5 'IF'
        NAXIS6 = Nants    CTYPE6 'ANTAXIS' (values in the ANTENNAS table)
      keywords: TELESCOP GNCONVEN CALTYPE CALSTYLE INTTIME CHWIDTH
      XORIENT TMERANGE LAT LON ALT + HISTORY cards.
      The axis encoding means times/freqs/jones must be uniformly spaced —
      a known property of the calfits convention.

  ANTENNAS extension
      binary table: ANTNAME (string), ANTINDEX (float64 antenna numbers),
      ANTARR (float64 ant_array, padded with -1 when Nants_data <
      Nants_telescope), optional ANTXYZ (3 x float64 positions).

  TOTQLTY extension (optional)
      total_quality_array image, FITS axes (Njones, Ntimes, Nfreqs, Nspws).

Everything is standard FITS: 2880-byte records, 80-char cards, big-endian
data, so any FITS library (astropy, fitsio, cfitsio) can open these files.
"""

from __future__ import annotations

import os

import numpy as np

RECORD = 2880


# ------------------------------------------------------------------ #
# FITS primitives
# ------------------------------------------------------------------ #
def _card(keyword, value=None, comment=None):
    """Format one 80-character FITS header card."""
    if keyword in ("HISTORY", "COMMENT"):
        return f"{keyword:<8.8s}{str(value):<72.72s}"[:80]
    key = f"{keyword:<8.8s}"
    if value is None:
        card = key
    else:
        if isinstance(value, (bool, np.bool_)):
            val = "T" if value else "F"
            card = f"{key}= {val:>20s}"
        elif isinstance(value, (int, np.integer)):
            card = f"{key}= {value:>20d}"
        elif isinstance(value, (float, np.floating)):
            card = f"{key}= {value:>20.13E}"
        else:
            # clamp so the card (incl. closing quote) stays within 80 chars;
            # an over-long value would otherwise lose its closing quote to
            # the final [:80] slice and corrupt the header
            sval = str(value).replace("'", "''")[:67]
            if sval.endswith("'") and not sval.endswith("''"):
                sval = sval[:-1]  # don't split an escaped '' pair
            card = f"{key}= '{sval:<8s}'"
        if comment:
            card += f" / {comment}"
    return f"{card:<80.80s}"[:80]


def _history_cards(history):
    """Split free text into HISTORY cards (70 chars each, newline-aware)."""
    cards = []
    for line in str(history or "").split("\n"):
        if not line:
            cards.append(_card("HISTORY", ""))
            continue
        while line:
            cards.append(_card("HISTORY", line[:70]))
            line = line[70:]
    return cards


def _header_bytes(cards):
    text = "".join(cards) + _card("END")
    raw = text.encode("ascii")
    rem = len(raw) % RECORD
    if rem:
        raw += b" " * (RECORD - rem)
    return raw


_BITPIX = {
    np.dtype(">u1"): 8,
    np.dtype(">i2"): 16,
    np.dtype(">i4"): 32,
    np.dtype(">i8"): 64,
    np.dtype(">f4"): -32,
    np.dtype(">f8"): -64,
}
_DTYPE_FOR_BITPIX = {v: k for k, v in _BITPIX.items()}


def _data_bytes(raw):
    rem = len(raw) % RECORD
    if rem:
        raw += b"\x00" * (RECORD - rem)
    return raw


def _parse_header(raw):
    """Parse header cards from 2880-byte records. HISTORY/COMMENT cards
    accumulate into lists. Returns (cards dict, bytes consumed)."""
    cards = {}
    pos = 0
    while True:
        record = raw[pos : pos + RECORD]
        for i in range(0, RECORD, 80):
            card = record[i : i + 80].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                return cards, pos + RECORD
            if key in ("HISTORY", "COMMENT"):
                cards.setdefault(key, []).append(card[8:].rstrip())
                continue
            if card[8:10] == "= ":
                body = card[10:]
                if body.strip().startswith("'"):
                    # string value: scan to the closing quote, skipping
                    # FITS-escaped '' pairs (a lone find() would truncate
                    # values containing an apostrophe)
                    first = body.find("'")
                    end = first + 1
                    while True:
                        end = body.find("'", end)
                        if end == -1 or body[end : end + 2] != "''":
                            break
                        end += 2
                    if end == -1:
                        end = len(body)
                    val = body[first + 1 : end].rstrip()
                    val = val.replace("''", "'")
                else:
                    if "/" in body:
                        body = body.split("/")[0]
                    body = body.strip()
                    if body == "T":
                        val = True
                    elif body == "F":
                        val = False
                    else:
                        try:
                            val = int(body)
                        except ValueError:
                            try:
                                val = float(body)
                            except ValueError:
                                val = body
                cards[key] = val
        pos += RECORD
        if pos >= len(raw):
            return cards, pos


def _read_hdus(path):
    """All HDUs of a FITS file as (cards, raw data bytes) pairs."""
    with open(path, "rb") as f:
        raw = f.read()
    hdus = []
    pos = 0
    while pos < len(raw):
        cards, hdr_len = _parse_header(raw[pos:])
        pos += hdr_len
        naxis = int(cards.get("NAXIS", 0))
        nbytes = 0
        if naxis > 0:
            count = 1
            for i in range(1, naxis + 1):
                count *= int(cards[f"NAXIS{i}"])
            nbytes = count * abs(int(cards["BITPIX"])) // 8
            nbytes += int(cards.get("PCOUNT", 0)) * abs(int(cards["BITPIX"])) // 8
        data = raw[pos : pos + nbytes]
        pos += ((nbytes + RECORD - 1) // RECORD) * RECORD if nbytes else 0
        hdus.append((cards, data))
    return hdus


def _image_array(cards, data):
    """Decode an image HDU payload into a C-ordered ndarray."""
    naxis = int(cards.get("NAXIS", 0))
    if naxis == 0:
        return None
    shape = tuple(int(cards[f"NAXIS{i}"]) for i in range(naxis, 0, -1))
    dtype = _DTYPE_FOR_BITPIX[int(cards["BITPIX"])]
    count = int(np.prod(shape))
    return np.frombuffer(data[: count * dtype.itemsize], dtype=dtype).reshape(shape)


def _hduaxis(cards, axis):
    """Reconstruct a linear world axis: CRVAL + (i + 1 - CRPIX) * CDELT.

    This is how calfits encodes the time/freq/jones axes (pyuvdata
    fits_utils._gethduaxis semantics)."""
    n = int(cards[f"NAXIS{axis}"])
    crval = float(cards[f"CRVAL{axis}"])
    cdelt = float(cards[f"CDELT{axis}"])
    crpix = float(cards.get(f"CRPIX{axis}", 1.0))
    return crval + (np.arange(n) + 1.0 - crpix) * cdelt


def _uniform_spacing(vals, fallback, what):
    """Spacing of a uniformly spaced axis; `fallback` for length-1 axes."""
    vals = np.asarray(vals, dtype=np.float64)
    if len(vals) < 2:
        return float(fallback)
    diffs = np.diff(vals)
    if not np.allclose(diffs, diffs[0], rtol=1e-8, atol=0.0):
        raise ValueError(
            f"The calfits format requires uniformly spaced {what}; got "
            f"spacings in [{diffs.min()}, {diffs.max()}]. Use calh5 output "
            "for irregular sampling."
        )
    return float(diffs[0])


# ------------------------------------------------------------------ #
# binary table (ANTENNAS HDU)
# ------------------------------------------------------------------ #
def _bintable_hdu(name, columns):
    """Serialize a binary-table HDU. columns: list of (ttype, tform, array)
    with tform in {'<n>A', 'D', '3D'}."""
    nrows = len(columns[0][2])
    row_fmt = []
    width = 0
    for _, tform, _ in columns:
        if tform.endswith("A"):
            n = int(tform[:-1])
            row_fmt.append(("A", n))
            width += n
        elif tform == "D":
            row_fmt.append(("D", 1))
            width += 8
        elif tform.endswith("D"):
            k = int(tform[:-1])
            row_fmt.append(("D", k))
            width += 8 * k
        else:  # pragma: no cover
            raise ValueError(f"unsupported TFORM {tform}")
    buf = bytearray()
    for r in range(nrows):
        for (kind, n), (_, _, arr) in zip(row_fmt, columns):
            if kind == "A":
                s = str(arr[r])[:n]
                buf += s.encode("ascii").ljust(n)
            else:
                vals = np.atleast_1d(np.asarray(arr[r], dtype=">f8"))
                buf += vals.tobytes()
    cards = [
        _card("XTENSION", "BINTABLE", "binary table extension"),
        _card("BITPIX", 8),
        _card("NAXIS", 2),
        _card("NAXIS1", width),
        _card("NAXIS2", nrows),
        _card("PCOUNT", 0),
        _card("GCOUNT", 1),
        _card("TFIELDS", len(columns)),
    ]
    for i, (ttype, tform, _) in enumerate(columns, start=1):
        cards.append(_card(f"TTYPE{i}", ttype))
        cards.append(_card(f"TFORM{i}", tform))
    cards.append(_card("EXTNAME", name))
    return _header_bytes(cards) + _data_bytes(bytes(buf))


def _parse_bintable(cards, data):
    """Decode a binary table into {ttype: list/array} columns."""
    nrows = int(cards["NAXIS2"])
    width = int(cards["NAXIS1"])
    nfields = int(cards["TFIELDS"])
    layout = []
    offset = 0
    for i in range(1, nfields + 1):
        tform = str(cards[f"TFORM{i}"]).strip()
        ttype = str(cards[f"TTYPE{i}"]).strip()
        if tform.endswith("A"):
            n = int(tform[:-1] or 1)
            layout.append((ttype, "A", n, offset))
            offset += n
        elif tform.endswith("D"):
            k = int(tform[:-1] or 1)
            layout.append((ttype, "D", k, offset))
            offset += 8 * k
        elif tform.endswith("E"):
            k = int(tform[:-1] or 1)
            layout.append((ttype, "E", k, offset))
            offset += 4 * k
        elif tform.endswith("J"):
            k = int(tform[:-1] or 1)
            layout.append((ttype, "J", k, offset))
            offset += 4 * k
        elif tform.endswith("K"):
            k = int(tform[:-1] or 1)
            layout.append((ttype, "K", k, offset))
            offset += 8 * k
        else:  # pragma: no cover
            raise ValueError(f"unsupported TFORM {tform}")
    dt = {"D": ">f8", "E": ">f4", "J": ">i4", "K": ">i8"}
    out = {}
    for ttype, kind, k, off in layout:
        vals = []
        for r in range(nrows):
            cell = data[r * width + off : r * width + off + (k if kind == "A" else 0)]
            if kind == "A":
                vals.append(cell.decode("ascii").rstrip())
            else:
                nb = k * int(dt[kind][-1])
                cell = data[r * width + off : r * width + off + nb]
                v = np.frombuffer(cell, dtype=dt[kind])
                vals.append(v[0] if k == 1 else v)
        out[ttype] = vals
    return out


# ------------------------------------------------------------------ #
# calfits write
# ------------------------------------------------------------------ #
def write_calfits(cal, path, clobber=False):
    """Write a CalData in the pyuvdata calfits gain-type layout."""
    if os.path.exists(path) and not clobber:
        raise IOError(f"{path} exists and clobber=False")
    cal._sync_metadata()
    if cal.cal_type not in (None, "gain"):
        raise NotImplementedError("only gain-type calfits output is supported")

    freqs = np.asarray(cal.freq_array, dtype=np.float64).reshape(-1)
    times = np.asarray(cal.time_array, dtype=np.float64).reshape(-1)
    jones = np.asarray(cal.jones_array, dtype=np.int64).reshape(-1)
    dfreq = _uniform_spacing(freqs, cal.channel_width or 1.0, "frequencies")
    itime = float(np.mean(cal.integration_time))
    dtime = _uniform_spacing(times, (itime or 1.0) / 86400.0, "times")
    djones = _uniform_spacing(jones, -1.0, "jones values")

    # primary data cube: (..., 4) = [gain.real, gain.imag, flag, quality]
    quality = (
        cal.quality_array
        if cal.quality_array is not None
        else np.zeros(cal.gain_array.shape, dtype=np.float64)
    )
    pridata = np.stack(
        [
            cal.gain_array.real,
            cal.gain_array.imag,
            cal.flag_array.astype(np.float64),
            quality.astype(np.float64),
        ],
        axis=-1,
    ).astype(">f8")
    # numpy C order (Nants, Nspws, Nfreqs, Ntimes, Njones, 4) reverses to
    # the calfits FITS axis order NAXIS1..6 = (4, Njones, Ntimes, Nfreqs,
    # Nspws, Nants)
    cards = [
        _card("SIMPLE", True, "conforms to FITS standard"),
        _card("BITPIX", -64),
        _card("NAXIS", 6),
    ]
    for i, n in enumerate(reversed(pridata.shape), start=1):
        cards.append(_card(f"NAXIS{i}", n))
    cards.append(_card("EXTEND", True))
    cards.extend(
        [
            _card("TELESCOP", cal.telescope_name),
            _card("LAT", float(cal.latitude)),
            _card("LON", float(cal.longitude)),
            _card("ALT", float(cal.altitude)),
            _card("GNCONVEN", cal.gain_convention),
            _card("CALTYPE", cal.cal_type or "gain"),
            _card("CALSTYLE", cal.cal_style),
            _card("INTTIME", itime),
            _card("CHWIDTH", float(cal.channel_width)),
            _card("XORIENT", cal.x_orientation or "east"),
        ]
    )
    if cal.time_range is not None:
        tr = np.asarray(cal.time_range, dtype=np.float64).reshape(-1)
        cards.append(_card("TMERANGE", f"{tr[0]:.17g},{tr[-1]:.17g}"))
    # world-coordinate axes (pyuvdata calfits convention, gain type)
    cards.extend(
        [
            _card("CTYPE1", "Narrays", "Number of image arrays."),
            _card("CUNIT1", "Integer"),
            _card("CRVAL1", 0.0),
            _card("CRPIX1", 1.0),
            _card("CDELT1", 1.0),
            _card("CTYPE2", "JONES", "Jones matrix array"),
            _card("CUNIT2", "Integer", "representative integer for polarization."),
            _card("CRVAL2", float(jones[0])),
            _card("CRPIX2", 1.0),
            _card("CDELT2", float(djones)),
            _card("CTYPE3", "TIME", "Time axis."),
            _card("CUNIT3", "JD", "Time in julian date format"),
            _card("CRVAL3", float(times[0])),
            _card("CRPIX3", 1.0),
            _card("CDELT3", float(dtime)),
            _card("CTYPE4", "FREQS", "Frequency."),
            _card("CUNIT4", "Hz"),
            _card("CRVAL4", float(freqs[0])),
            _card("CRPIX4", 1.0),
            _card("CDELT4", float(dfreq)),
            _card("CTYPE5", "IF", "Spectral window number."),
            _card("CUNIT5", "Integer"),
            _card("CRVAL5", 1.0),
            _card("CRPIX5", 1.0),
            _card("CDELT5", 1.0),
            _card("CTYPE6", "ANTAXIS", "See ANTARR in ANTENNAS extension for values."),
        ]
    )
    cards.extend(_history_cards(cal.history))
    blob = _header_bytes(cards) + _data_bytes(pridata.tobytes())

    # ANTENNAS binary table: one row per telescope antenna; ANTARR padded
    # with -1 where the antenna has no solution (pyuvdata convention)
    nants_tel = int(cal.Nants_telescope)
    if cal.antenna_numbers is not None:
        ant_numbers = np.asarray(cal.antenna_numbers, dtype=np.float64)
    else:
        ant_numbers = np.asarray(cal.ant_array, dtype=np.float64)
    if cal.antenna_names is not None:
        ant_names = [str(n) for n in cal.antenna_names]
    else:
        ant_names = [f"ant{int(n)}" for n in ant_numbers]
    ant_arr = np.full(nants_tel, -1.0)
    ant_arr[: cal.Nants_data] = np.asarray(cal.ant_array, dtype=np.float64)
    name_len = max(8, max(len(n) for n in ant_names))
    columns = [
        ("ANTNAME", f"{name_len}A", ant_names),
        ("ANTINDEX", "D", ant_numbers),
        ("ANTARR", "D", ant_arr),
    ]
    if cal.antenna_positions is not None:
        antpos = np.asarray(cal.antenna_positions, dtype=np.float64)
        # one row per telescope antenna; omit when the positions don't
        # cover the full table (optional column in the convention)
        if antpos.shape[0] == nants_tel:
            columns.append(("ANTXYZ", "3D", antpos))
    blob += _bintable_hdu("ANTENNAS", columns)

    total_quality = getattr(cal, "total_quality_array", None)
    if total_quality is not None:
        tq = np.asarray(total_quality, dtype=">f8")
        tq_cards = [
            _card("XTENSION", "IMAGE", "Image extension"),
            _card("BITPIX", -64),
            _card("NAXIS", tq.ndim),
        ]
        for i, n in enumerate(reversed(tq.shape), start=1):
            tq_cards.append(_card(f"NAXIS{i}", n))
        tq_cards.extend([_card("PCOUNT", 0), _card("GCOUNT", 1), _card("EXTNAME", "TOTQLTY")])
        blob += _header_bytes(tq_cards) + _data_bytes(tq.tobytes())

    with open(path, "wb") as f:
        f.write(blob)


# ------------------------------------------------------------------ #
# calfits read
# ------------------------------------------------------------------ #
def read_calfits(cls, path):
    """Read a pyuvdata-layout calfits file into a CalData."""
    hdus = _read_hdus(path)
    pcards, pdata = hdus[0]
    named = {}
    for cards, data in hdus[1:]:
        named[str(cards.get("EXTNAME", "")).strip()] = (cards, data)

    obj = cls()
    obj.telescope_name = str(pcards.get("TELESCOP", "unknown")).strip()
    obj.latitude = float(pcards.get("LAT", 0.0))
    obj.longitude = float(pcards.get("LON", 0.0))
    obj.altitude = float(pcards.get("ALT", 0.0))
    obj.gain_convention = str(pcards.get("GNCONVEN", "divide")).strip()
    obj.cal_type = str(pcards.get("CALTYPE", "gain")).strip()
    obj.cal_style = str(pcards.get("CALSTYLE", "redundant")).strip()
    obj.integration_time = float(pcards.get("INTTIME", 0.0))
    obj.channel_width = float(pcards.get("CHWIDTH", 0.0))
    xorient = str(pcards.get("XORIENT", "")).strip()
    obj.x_orientation = xorient or None
    obj.history = "\n".join(pcards.get("HISTORY", []))
    if "TMERANGE" in pcards:
        obj.time_range = np.asarray(
            [float(v) for v in str(pcards["TMERANGE"]).split(",")]
        )
    if obj.cal_type != "gain":
        raise NotImplementedError("only gain-type calfits files are supported")

    # axes from the WCS cards
    obj.jones_array = np.asarray(np.rint(_hduaxis(pcards, 2)), dtype=np.int64)
    obj.time_array = _hduaxis(pcards, 3)
    obj.freq_array = _hduaxis(pcards, 4)[None, :]
    obj.spw_array = np.arange(int(pcards["NAXIS5"]))

    pridata = _image_array(pcards, pdata).astype(np.float64)
    # FITS reversed -> C order (Nants, Nspws, Nfreqs, Ntimes, Njones, 4)
    obj.gain_array = pridata[..., 0] + 1j * pridata[..., 1]
    obj.flag_array = pridata[..., 2].astype(bool)
    obj.quality_array = pridata[..., 3]

    if "ANTENNAS" in named:
        tcards, tdata = named["ANTENNAS"]
        cols = _parse_bintable(tcards, tdata)
        obj.antenna_names = [str(n) for n in cols.get("ANTNAME", [])]
        obj.antenna_numbers = np.asarray(cols.get("ANTINDEX", []), dtype=np.int64)
        ant_arr = np.asarray(cols.get("ANTARR", []), dtype=np.int64)
        nants_data = obj.gain_array.shape[0]
        obj.ant_array = ant_arr[:nants_data]
        if "ANTXYZ" in cols:
            obj.antenna_positions = np.asarray(cols["ANTXYZ"], dtype=np.float64)
    else:  # pragma: no cover
        obj.ant_array = np.arange(obj.gain_array.shape[0])

    if "TOTQLTY" in named:
        tq_cards, tq_data = named["TOTQLTY"]
        obj.total_quality_array = _image_array(tq_cards, tq_data).astype(np.float64)

    obj._sync_metadata()
    return obj
