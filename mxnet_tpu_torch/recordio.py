"""RecordIO: MXNet's binary record container (parity: python/mxnet/recordio.py).

The counterpart of ``mxnet_tpu/recordio.py``, bit-compatible with it in both
directions.  A record is ``[magic 0xced7230a u32][lrec u32: cflag << 29 |
length][data][zero pad to 4 bytes]``; an ``.idx`` file holds one
``key\\toffset`` line per record.  ``IRHeader`` packs (flag u32, label f32,
id u64, id2 u64) little-endian; a vector label rides in front of the payload
as ``flag`` float32s.

Payloads are decoded by their magic bytes: ``.npy`` (``\\x93NUMPY``) by
numpy's header reader, the array read from the payload's bytes in place;
JPEG and PNG by cv2 (BGR, as MXNet's decoder) or, without cv2, by PIL
(turned to BGR).  Anything else raises ``MXNetError``.
"""
from __future__ import annotations

import functools
import io
import os
import struct
import threading
from collections import namedtuple

import numpy as _np

from .base import MXNetError

_KMAGIC = 0xced7230a
_LEN_MASK = (1 << 29) - 1
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)

_NPY_MAGIC = b"\x93NUMPY"
_JPEG_MAGIC = b"\xff\xd8\xff"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


class MXRecordIO:
    """Sequential ``.rec`` reader (``flag="r"``) or writer (``"w"``)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.record = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"Invalid flag {self.flag}")
        self.is_open = True

    def close(self):
        if self.is_open:
            self.record.close()
            self.is_open = False

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["is_open"] = False
        d.pop("record", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)

    def reset(self):
        self.close()
        self.open()

    def tell(self) -> int:
        """The byte offset of the next record."""
        return self.record.tell()

    def seek(self, pos: int) -> None:
        """Jump to an offset that ``tell`` returned (read mode)."""
        assert not self.writable
        self.record.seek(pos)

    def write(self, buf: bytes):
        assert self.writable
        pad = (4 - len(buf) % 4) % 4
        self.record.write(struct.pack("<II", _KMAGIC, len(buf)) + buf
                          + b"\x00" * pad)

    def read(self):
        """The next record's bytes, or None at the end of the file."""
        assert not self.writable
        header = self.record.read(8)
        if len(header) < 8:
            return None
        magic, lrec = struct.unpack("<II", header)
        if magic != _KMAGIC:
            raise MXNetError("invalid record magic")
        length = lrec & _LEN_MASK
        buf = self.record.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.record.read(pad)
        return buf


class MXIndexedRecordIO(MXRecordIO):
    """``.rec`` with an ``.idx`` for random access by key.  ``read_idx`` may
    be called from several threads at once (a ``DataLoader``'s workers)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        self._lock = threading.Lock()
        super().__init__(uri, flag)

    def __getstate__(self):
        d = super().__getstate__()
        d.pop("_lock")
        return d

    def __setstate__(self, d):
        super().__setstate__(d)
        self._lock = threading.Lock()

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.fidx is not None and not self.fidx.closed:
            self.fidx.close()
        super().close()

    def seek(self, idx):
        assert not self.writable
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        # seek and read share the file's position: one reader at a time
        with self._lock:
            self.seek(idx)
            return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


def pack(header: IRHeader, s: bytes) -> bytes:
    """A header and a payload as one record's bytes; a vector label goes
    in front of the payload, its length in ``flag``."""
    header = IRHeader(*header)
    if isinstance(header.label, (list, tuple, _np.ndarray)):
        label = _np.asarray(header.label, dtype=_np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s: bytes):
    """(header, payload) of a record; a vector label comes back as a
    float32 array in ``header.label``."""
    header, offset = _header(s)
    return header, s[offset:]


def _header(s):
    """(header, offset of the payload) of a record's bytes."""
    header = IRHeader(*struct.unpack_from(_IR_FORMAT, s))
    if header.flag > 0:
        label = _np.frombuffer(s, _np.float32, count=header.flag,
                               offset=_IR_SIZE)
        return header._replace(label=label), _IR_SIZE + header.flag * 4
    return header, _IR_SIZE


def unpack_img(s, iscolor=-1):
    """(header, HWC uint8 image) of a record (BGR for colour images)."""
    header, s = unpack(s)
    return header, _imdecode_bytes(s, iscolor)


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """A header and an image (BGR) as one record, encoded as ``img_fmt``:
    ``.jpg``/``.png`` through cv2 or PIL, ``.npy`` by numpy alone."""
    return pack(header, _imencode(img, quality, img_fmt))


def _decoders():
    try:
        import cv2
        return cv2, None
    except ImportError:
        pass
    try:
        from PIL import Image
        return None, Image
    except ImportError:
        return None, None


@functools.lru_cache(maxsize=64)
def _npy_header(head: bytes):
    """(shape, fortran order, dtype, data offset) of a ``.npy`` header:
    numpy's reader, once per distinct header (a record set's images
    share one)."""
    f = io.BytesIO(head)
    version = _np.lib.format.read_magic(f)
    read = _np.lib.format.read_array_header_1_0 if version == (1, 0) \
        else _np.lib.format.read_array_header_2_0
    shape, fortran, dtype = read(f)
    if dtype.hasobject:
        raise MXNetError(".npy payloads of Python objects are not loaded")
    return shape, fortran, dtype, f.tell()


def _npy_view(buf) -> _np.ndarray:
    """A ``.npy`` payload as a read-only array over ``buf`` itself (no copy
    of the data)."""
    head = bytes(buf[:12])
    size = 2 if head[6] == 1 else 4       # the header length's own width
    shape, fortran, dtype, offset = _npy_header(bytes(
        buf[:8 + size + int.from_bytes(head[8:8 + size], "little")]))
    arr = _np.frombuffer(buf, dtype, count=int(_np.prod(shape)),
                         offset=offset)
    return arr.reshape(shape, order="F" if fortran else "C")


def _imdecode_view(buf, iscolor=-1) -> _np.ndarray:
    """``_imdecode_bytes`` without a copy for ``.npy`` payloads: the array
    may be a read-only view over ``buf``."""
    head = bytes(buf[:8])
    if head.startswith(_NPY_MAGIC):
        return _npy_view(buf)
    if not head.startswith((_JPEG_MAGIC, _PNG_MAGIC)):
        raise MXNetError(f"unknown image payload (starts {head!r}): "
                         "not .npy, JPEG or PNG")
    cv2, pil = _decoders()
    if cv2 is not None:
        return cv2.imdecode(_np.frombuffer(buf, _np.uint8), iscolor)
    if pil is not None:
        img = _np.asarray(pil.open(io.BytesIO(bytes(buf))))
        return img[:, :, ::-1] if img.ndim == 3 else img
    raise MXNetError("decoding a JPEG or PNG payload needs cv2 or PIL, and "
                     "neither is installed; write .npy payloads "
                     "(pack_img(..., img_fmt='.npy')) instead")


def _imdecode_bytes(buf: bytes, iscolor=-1) -> _np.ndarray:
    """Decode a payload by its magic bytes: ``.npy`` as stored, JPEG and PNG
    through cv2 (``iscolor`` is its flag) or PIL, channels in BGR order."""
    img = _imdecode_view(buf, iscolor)
    return img.copy() if img is not None and not img.flags.writeable \
        else img


def _imencode(img, quality=95, img_fmt=".jpg"):
    if img_fmt == ".npy":
        b = io.BytesIO()
        _np.save(b, _np.asarray(img), allow_pickle=False)
        return b.getvalue()
    cv2, pil = _decoders()
    if cv2 is not None:
        params = [cv2.IMWRITE_JPEG_QUALITY, quality] \
            if img_fmt in (".jpg", ".jpeg") else []
        ret, buf = cv2.imencode(img_fmt, img, params)
        if not ret:
            raise MXNetError(f"cv2 could not encode {img_fmt}")
        return buf.tobytes()
    if pil is not None:
        b = io.BytesIO()
        arr = _np.asarray(img)
        if arr.ndim == 3:
            arr = arr[:, :, ::-1]
        pil.fromarray(arr).save(b, format="JPEG" if "jp" in img_fmt
                                else "PNG", quality=quality)
        return b.getvalue()
    raise MXNetError(f"encoding {img_fmt} needs cv2 or PIL, and neither is "
                     "installed; use img_fmt='.npy'")
