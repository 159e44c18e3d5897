"""RecordIO read and write: the port of `mxnet_tpu/recordio.py` (parity
`python/mxnet/recordio.py`: `MXRecordIO`, `MXIndexedRecordIO`, `IRHeader`,
`pack` / `unpack` and the image forms), over the dmlc-core RecordIO stream
format that the reference's `tools/im2rec` writes:

    each record = [kMagic:u32][lrec:u32][data][pad to 4 B]

where the upper 3 bits of ``lrec`` are the continue flag (records split
around the magic word; this writer writes whole records, flag 0) and the
lower 29 bits the length. The files this module writes are byte-identical
to the JAX package's, and each reads the other's.

The JAX package scans a file in C when its native runtime is built
(`read_all_records`, `list_record_offsets`); the port keeps one pure-Python
scan over the file's bytes. Image encode and decode are host work, as in
the reference (OpenCV in `src/io`): cv2, else PIL, imported only inside
`pack_img` / `unpack_img`.
"""
from __future__ import annotations

import collections
import numbers
import os
import struct
import threading

import numpy as np

from .resilience import inject, open_checked, retry_call

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img", "read_all_records",
           "list_record_offsets"]

_kMagic = 0xced7230a
_LEN_MASK = 0x1FFFFFFF


def _pad(length):
    return (4 - length % 4) % 4


class MXRecordIO:
    """Sequential RecordIO reader (``flag="r"``) or writer (``"w"``)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.record = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open_checked(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open_checked(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()

    def __del__(self):
        self.close()

    def __getstate__(self):
        """Pickled without its file (DataLoader worker processes reopen)."""
        d = dict(self.__dict__)
        d["record"] = None
        d["pid"] = None
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        self.open()

    def _check_pid(self, allow_reset=False):
        """Reopen in a process other than the opener's (a reader), or
        refuse (a writer)."""
        if self.pid != os.getpid():
            if allow_reset:
                self.reset()
            else:
                raise RuntimeError("Forbidden operation in multiple processes")

    def close(self):
        if self.record is not None and not self.record.closed:
            self.record.close()

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        """Append ``buf`` (bytes) as one record."""
        assert self.writable
        self._check_pid(allow_reset=False)
        data = bytes(buf)
        self.record.write(struct.pack("<II", _kMagic, len(data) & _LEN_MASK))
        self.record.write(data)
        pad = _pad(len(data))
        if pad:
            self.record.write(b"\x00" * pad)

    def tell(self):
        assert self.writable
        return self.record.tell()

    def _frame(self):
        header = self.record.read(8)
        if len(header) < 8:
            return None, None
        magic, lrec = struct.unpack("<II", header)
        assert magic == _kMagic, "Invalid record magic"
        length = lrec & _LEN_MASK
        data = self.record.read(length)
        pad = _pad(length)
        if pad:
            self.record.read(pad)
        return data, lrec >> 29

    def read(self):
        """The next record as bytes, or None at the end. Carries the
        ``read`` fault point; not retried (`MXIndexedRecordIO.read_idx`
        is)."""
        assert not self.writable
        self._check_pid(allow_reset=True)
        inject("read", self.uri)
        data, cflag = self._frame()
        if data is None or cflag == 0:
            return data
        parts = [data]  # a split record: continuation frames up to flag 3
        while cflag in (1, 2):
            part, cflag = self._frame()
            parts.append(part)
        return b"".join(parts)


def _scan(uri):
    """[(offset of the frame header, continue flag, payload)] of every
    frame of a RecordIO file, in one pass over its bytes."""
    with open_checked(uri, "rb") as f:
        buf = f.read()
    frames, pos, end = [], 0, len(buf)
    while pos + 8 <= end:
        magic, lrec = struct.unpack_from("<II", buf, pos)
        assert magic == _kMagic, "Invalid record magic"
        length = lrec & _LEN_MASK
        frames.append((pos, lrec >> 29, buf[pos + 8:pos + 8 + length]))
        pos += 8 + length + _pad(length)
    return frames


def read_all_records(uri):
    """Every logical record of a RecordIO file, as a list of bytes."""
    out, parts = [], None
    for _, cflag, data in _scan(uri):
        if cflag == 0:
            out.append(data)
        elif cflag == 1:
            parts = [data]
        else:
            parts.append(data)
            if cflag == 3:
                out.append(b"".join(parts))
    return out


def list_record_offsets(uri):
    """Byte offsets of every logical record's first frame header (what
    `MXIndexedRecordIO` seeks to): the index the reference's
    `tools/rec2idx.py` builds."""
    return [pos for pos, cflag, _ in _scan(uri) if cflag in (0, 1)]


class MXIndexedRecordIO(MXRecordIO):
    """Random-access RecordIO through a ``.idx`` file of ``key\\tposition``
    lines. `read_idx` may be called from several threads at once (a
    `DataLoader`'s thread pool): each seek and read holds a lock."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        self._lock = threading.Lock()
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin.readlines():
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)
        if self.writable:
            self.fidx = open(self.idx_path, "w")

    def close(self):
        super().close()
        if self.fidx is not None and not self.fidx.closed:
            self.fidx.close()

    def __getstate__(self):
        d = super().__getstate__()
        d["fidx"] = None
        d["_lock"] = None
        return d

    def __setstate__(self, d):
        d["_lock"] = threading.Lock()
        super().__setstate__(d)

    def seek(self, idx):
        assert not self.writable
        self._check_pid(allow_reset=True)
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        """The record of key ``idx``; a transient read error is retried
        from the index offset."""
        def attempt():
            with self._lock:
                self.seek(idx)
                return self.read()

        return retry_call(attempt, desc=f"read_idx({idx}) of {self.uri}")

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


# the header of an image record from the reference's tools/im2rec
IRHeader = collections.namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """A record from ``header`` (an `IRHeader`; a label array is stored
    before the payload, its length in ``flag``) and the payload bytes."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s):
    """(header, payload bytes) of a record; a multi-label header's label
    is a float32 array."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=-1):
    """(header, decoded HWC image, BGR as OpenCV gives it) of a record."""
    header, s = unpack(s)
    return header, _imdecode(np.frombuffer(s, dtype=np.uint8), iscolor)


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """A record of ``img`` (HWC, BGR) encoded as ``img_fmt``."""
    return pack(header, _imencode(img, quality, img_fmt))


def _imdecode(buf, iscolor):
    try:
        import cv2
        return cv2.imdecode(buf, iscolor)
    except ImportError:
        pass
    try:
        import io
        from PIL import Image
    except ImportError as e:
        raise ImportError("unpack_img requires cv2 or PIL") from e
    img = np.asarray(Image.open(io.BytesIO(buf.tobytes())))
    if img.ndim == 3:
        img = img[:, :, ::-1]  # RGB -> BGR, OpenCV's order
    return img


def _imencode(img, quality, img_fmt):
    try:
        import cv2
        encode_params = None
        if img_fmt.upper() in (".JPG", ".JPEG"):
            encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
        elif img_fmt.upper() == ".PNG":
            encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
        ret, buf = cv2.imencode(img_fmt, img, encode_params)
        assert ret, "failed to encode image"
        return buf.tobytes()
    except ImportError:
        pass
    try:
        import io
        from PIL import Image
    except ImportError as e:
        raise ImportError("pack_img requires cv2 or PIL") from e
    arr = img[:, :, ::-1] if img.ndim == 3 else img  # BGR -> RGB
    bio = io.BytesIO()
    Image.fromarray(arr).save(
        bio, format=img_fmt.strip(".").upper().replace("JPG", "JPEG"),
        quality=quality)
    return bio.getvalue()
