"""Self-contained ONNX protobuf codec (no ``onnx`` package needed).

A copy of ``handyrl_tpu.interop.onnx_proto``: the same schema slice,
encoder and decoder, byte for byte, so a file either package writes
decodes in the other and the same message dict encodes to the same
bytes.  Protobuf is a simple TLV encoding, and the slice of
``onnx.proto`` a policy net needs is small.

Messages are plain dicts keyed by field name; repeated fields are
lists.  ``SCHEMAS`` maps message name -> {field number: (name, kind,
submessage)} with kinds:

  int    — varint (int64/enum/bool)
  str    — length-delimited utf-8
  bytes  — length-delimited raw
  float  — fixed32
  msg    — nested message
  packed — packed repeated varints (also accepts unpacked)

Field numbers follow the official ``onnx/onnx.proto`` (stable since
IR version 3).
"""

import struct

# kind tags
INT, STR, BYTES, FLT, MSG, PACKED = "int", "str", "bytes", "float", \
    "msg", "packed"

# (name, kind, repeated, submessage-name)
SCHEMAS = {
    "Model": {
        1: ("ir_version", INT, False, None),
        8: ("opset_import", MSG, True, "OperatorSetId"),
        2: ("producer_name", STR, False, None),
        3: ("producer_version", STR, False, None),
        4: ("domain", STR, False, None),
        5: ("model_version", INT, False, None),
        6: ("doc_string", STR, False, None),
        7: ("graph", MSG, False, "Graph"),
    },
    "OperatorSetId": {
        1: ("domain", STR, False, None),
        2: ("version", INT, False, None),
    },
    "Graph": {
        1: ("node", MSG, True, "Node"),
        2: ("name", STR, False, None),
        5: ("initializer", MSG, True, "Tensor"),
        10: ("doc_string", STR, False, None),
        11: ("input", MSG, True, "ValueInfo"),
        12: ("output", MSG, True, "ValueInfo"),
        13: ("value_info", MSG, True, "ValueInfo"),
    },
    "Node": {
        1: ("input", STR, True, None),
        2: ("output", STR, True, None),
        3: ("name", STR, False, None),
        4: ("op_type", STR, False, None),
        7: ("domain", STR, False, None),
        5: ("attribute", MSG, True, "Attribute"),
        6: ("doc_string", STR, False, None),
    },
    "Attribute": {
        1: ("name", STR, False, None),
        20: ("type", INT, False, None),
        2: ("f", FLT, False, None),
        3: ("i", INT, False, None),
        4: ("s", BYTES, False, None),
        5: ("t", MSG, False, "Tensor"),
        7: ("floats", FLT, True, None),
        8: ("ints", PACKED, True, None),
        9: ("strings", BYTES, True, None),
    },
    "Tensor": {
        1: ("dims", PACKED, True, None),
        2: ("data_type", INT, False, None),
        4: ("float_data", FLT, True, None),
        5: ("int32_data", PACKED, True, None),
        7: ("int64_data", PACKED, True, None),
        8: ("name", STR, False, None),
        9: ("raw_data", BYTES, False, None),
    },
    "ValueInfo": {
        1: ("name", STR, False, None),
        2: ("type", MSG, False, "Type"),
    },
    "Type": {
        1: ("tensor_type", MSG, False, "TypeTensor"),
    },
    "TypeTensor": {
        1: ("elem_type", INT, False, None),
        2: ("shape", MSG, False, "TensorShape"),
    },
    "TensorShape": {
        1: ("dim", MSG, True, "Dimension"),
    },
    "Dimension": {
        1: ("dim_value", INT, False, None),
        2: ("dim_param", STR, False, None),
    },
}

# AttributeProto.AttributeType values
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8

# TensorProto.DataType values
DT_FLOAT, DT_UINT8, DT_INT8, DT_INT32, DT_INT64 = 1, 2, 3, 6, 7
DT_BOOL, DT_FLOAT16, DT_DOUBLE, DT_BFLOAT16 = 9, 10, 11, 16


# -- encoding -----------------------------------------------------------

def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # two's complement, 10 bytes (protobuf int64)
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def encode(msg: dict, schema_name: str) -> bytes:
    schema = SCHEMAS[schema_name]
    by_name = {spec[0]: (num, spec) for num, spec in schema.items()}
    out = bytearray()
    for name, value in msg.items():
        if value is None:
            continue
        num, (_, kind, repeated, sub) = by_name[name]
        values = value if repeated else [value]
        if kind == PACKED:
            payload = b"".join(_varint(int(v)) for v in values)
            out += _tag(num, 2) + _varint(len(payload)) + payload
            continue
        for v in values:
            if kind == INT:
                out += _tag(num, 0) + _varint(int(v))
            elif kind == STR:
                raw = v.encode() if isinstance(v, str) else bytes(v)
                out += _tag(num, 2) + _varint(len(raw)) + raw
            elif kind == BYTES:
                out += _tag(num, 2) + _varint(len(v)) + bytes(v)
            elif kind == FLT:
                out += _tag(num, 5) + struct.pack("<f", float(v))
            elif kind == MSG:
                raw = encode(v, sub)
                out += _tag(num, 2) + _varint(len(raw)) + raw
            else:  # pragma: no cover
                raise ValueError(f"unknown kind {kind}")
    return bytes(out)


# -- decoding -----------------------------------------------------------

def _read_varint(buf, pos):
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            if result >= 1 << 63:
                result -= 1 << 64
            return result, pos
        shift += 7


def decode(buf: bytes, schema_name: str) -> dict:
    schema = SCHEMAS[schema_name]
    msg = {}
    for num, (name, _, repeated, _) in schema.items():
        if repeated:
            msg[name] = []
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        spec = schema.get(field)
        # read the raw value per wire type
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            value = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif wire == 1:
            value = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")
        if spec is None:
            continue  # unknown field: skip (forward compatible)
        name, kind, repeated, sub = spec
        if kind == INT:
            pass
        elif kind == STR:
            value = bytes(value).decode("utf-8", "replace")
        elif kind == BYTES:
            value = bytes(value)
        elif kind == FLT:
            if wire == 2:  # packed floats
                raw = bytes(value)
                floats = [struct.unpack("<f", raw[i:i + 4])[0]
                          for i in range(0, len(raw), 4)]
                msg[name].extend(floats) if repeated else None
                continue
        elif kind == PACKED:
            if wire == 2:
                raw = bytes(value)
                p = 0
                while p < len(raw):
                    v, p = _read_varint(raw, p)
                    msg[name].append(v)
                continue
            # unpacked single varint falls through
        elif kind == MSG:
            value = decode(bytes(value), sub)
        if repeated:
            msg[name].append(value)
        else:
            msg[name] = value
    return msg
