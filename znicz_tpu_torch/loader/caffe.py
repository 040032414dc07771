"""The Caffe protobuf wire codec: ``Datum`` and ``BlobProto``.

Counterpart of ``znicz_tpu/loader/caffe.py`` (the port keeps its own
copy): a hand-written codec for the two messages the LMDB loader
needs, so no protobuf package is required.  The same fields give the
same bytes in either package, and each decodes the other's.

Schema (caffe.proto)::

    message Datum {
      optional int32 channels = 1;   optional int32 height = 2;
      optional int32 width = 3;      optional bytes data = 4;
      optional int32 label = 5;      repeated float float_data = 6;
    }
    message BlobProto {
      optional int32 num = 1;        optional int32 channels = 2;
      optional int32 height = 3;     optional int32 width = 4;
      repeated float data = 5 [packed]; repeated float diff = 6 [packed];
    }
"""

import struct


def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(out, value):
    if value < 0:
        value += 1 << 64  # two's-complement negative int32/int64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _signed32(value):
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= (1 << 31) else value


def _iter_fields(buf):
    """Yield (field_number, wire_type, value) over a serialized message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:                      # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 1:                    # 64-bit
            value = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:                    # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:                    # 32-bit
            value = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError("unsupported wire type %d" % wire)
        yield field, wire, value


class Datum(object):
    """One Caffe dataset record (image bytes + label)."""

    __slots__ = ("channels", "height", "width", "data", "label",
                 "float_data")

    def __init__(self, channels=0, height=0, width=0, data=b"", label=0,
                 float_data=None):
        self.channels = channels
        self.height = height
        self.width = width
        self.data = data
        self.label = label
        self.float_data = list(float_data or [])

    def ParseFromString(self, buf):
        self.__init__()
        for field, wire, value in _iter_fields(bytes(buf)):
            if field == 1:
                self.channels = _signed32(value)
            elif field == 2:
                self.height = _signed32(value)
            elif field == 3:
                self.width = _signed32(value)
            elif field == 4:
                self.data = bytes(value)
            elif field == 5:
                self.label = _signed32(value)
            elif field == 6:
                if wire == 5:
                    self.float_data.append(struct.unpack("<f", value)[0])
                else:  # packed
                    self.float_data.extend(
                        struct.unpack("<%df" % (len(value) // 4), value))
        return self

    def SerializeToString(self):
        out = bytearray()
        for field, value in ((1, self.channels), (2, self.height),
                             (3, self.width)):
            if value:
                _write_varint(out, field << 3)
                _write_varint(out, value)
        if self.data:
            _write_varint(out, (4 << 3) | 2)
            _write_varint(out, len(self.data))
            out.extend(self.data)
        if self.label:
            _write_varint(out, 5 << 3)
            _write_varint(out, self.label)
        for f in self.float_data:
            _write_varint(out, (6 << 3) | 5)
            out.extend(struct.pack("<f", f))
        return bytes(out)


class BlobProto(object):
    """Caffe blob (used for mean files)."""

    __slots__ = ("num", "channels", "height", "width", "data", "diff")

    def __init__(self):
        self.num = self.channels = self.height = self.width = 0
        self.data = []
        self.diff = []

    def ParseFromString(self, buf):
        self.__init__()
        for field, wire, value in _iter_fields(bytes(buf)):
            if field == 1:
                self.num = _signed32(value)
            elif field == 2:
                self.channels = _signed32(value)
            elif field == 3:
                self.height = _signed32(value)
            elif field == 4:
                self.width = _signed32(value)
            elif field in (5, 6):
                target = self.data if field == 5 else self.diff
                if wire == 5:
                    target.append(struct.unpack("<f", value)[0])
                else:  # packed (the generated schema marks these packed)
                    target.extend(
                        struct.unpack("<%df" % (len(value) // 4), value))
        return self

    def SerializeToString(self):
        out = bytearray()
        for field, value in ((1, self.num), (2, self.channels),
                             (3, self.height), (4, self.width)):
            if value:
                _write_varint(out, field << 3)
                _write_varint(out, value)
        for field, values in ((5, self.data), (6, self.diff)):
            if values:
                payload = struct.pack("<%df" % len(values), *values)
                _write_varint(out, (field << 3) | 2)
                _write_varint(out, len(payload))
                out.extend(payload)
        return bytes(out)
