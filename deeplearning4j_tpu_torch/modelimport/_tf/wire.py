"""The protobuf wire format of the TF GraphDef subset, in plain Python —
the port's counterpart of `deeplearning4j_tpu/modelimport/_tf/
tf_graph_subset_pb2.py`, which needs ``google.protobuf``.

The messages are those of ``tf_graph_subset.proto`` (same field numbers
and types): `TensorShapeProto` (with ``Dim``), `TensorProto`,
`AttrValue` (with ``ListValue``), `NameAttrList`, `NodeDef`,
`VersionDef`, `OpDef` (with ``ArgDef``), `FunctionDef`,
`FunctionDefLibrary`, `GraphDef`, and the `DataType` enum.  They keep the
part of the generated classes' API the importer and the graph writer use:
attribute access with proto3 defaults, repeated fields as lists
(``add()`` on repeated messages), maps as dicts whose missing keys
create their value, ``WhichOneof``, ``CopyFrom``,
``SerializeToString``, ``ParseFromString`` and ``==``.

The codec:

- varints, with negative int32 / int64 / enum values as ten bytes (two's
  complement over 64 bits), no zigzag (the subset has no sint fields);
- fixed32 (float) and fixed64 (double);
- length-delimited fields: strings, bytes, messages, packed repeated
  scalars, map entries (key 1, value 2);
- repeated scalars are written packed (proto3's default) and read packed
  or unpacked;
- unknown fields are skipped (groups included);
- a singular scalar is written when it differs from its default, a oneof
  member whenever it is set, a message when it is present (parsed, or
  written to).

`TensorProto.tensor_content` parses to a `memoryview` of the input
buffer, never a copy: a full-width BERT graph is ~440 MB of it, and
`numpy.frombuffer` reads it in place.  Serialising gathers the chunks of
the whole message and joins them once.
"""

from __future__ import annotations

import struct

__all__ = [
    "DataType", "TensorShapeProto", "TensorProto", "AttrValue", "NameAttrList",
    "NodeDef", "VersionDef", "OpDef", "FunctionDef", "FunctionDefLibrary",
    "GraphDef", "DecodeError",
]


class DecodeError(ValueError):
    """The bytes are not a well-formed message of the subset."""


class DataType:
    """The ``DataType`` enum (values as in TensorFlow's types.proto)."""

    DT_INVALID, DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8, DT_INT16 = 0, 1, 2, 3, 4, 5
    DT_INT8, DT_STRING, DT_COMPLEX64, DT_INT64, DT_BOOL, DT_QINT8 = 6, 7, 8, 9, 10, 11
    DT_QUINT8, DT_QINT32, DT_BFLOAT16, DT_QINT16, DT_QUINT16 = 12, 13, 14, 15, 16
    DT_UINT16, DT_COMPLEX128, DT_HALF, DT_RESOURCE, DT_VARIANT = 17, 18, 19, 20, 21
    DT_UINT32, DT_UINT64 = 22, 23


_M64 = (1 << 64) - 1
_VARINT = ("int32", "int64", "uint32", "uint64", "bool", "enum")
_PACKABLE = _VARINT + ("float", "double")
_DEFAULTS = {"int32": 0, "int64": 0, "uint32": 0, "uint64": 0, "bool": False,
             "enum": 0, "float": 0.0, "double": 0.0, "string": "", "bytes": b""}


# -- primitives ----------------------------------------------------------------

def _varint(v: int) -> bytes:
    v &= _M64
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _read_varint(buf, pos: int):
    result = shift = 0
    while True:
        try:
            b = buf[pos]
        except IndexError:
            raise DecodeError("truncated varint") from None
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _from_varint(kind: str, v: int):
    if kind == "bool":
        return v != 0
    if kind == "uint32":
        return v & 0xFFFFFFFF
    if kind == "uint64":
        return v & _M64
    if kind == "int64":
        return _signed(v, 64)
    return _signed(v, 32)          # int32, enum


def _encode_scalar(kind: str, v) -> bytes:
    if kind in _VARINT:
        return _varint(int(v))
    if kind == "float":
        return struct.pack("<f", v)
    return struct.pack("<d", v)


def _wire_type(kind: str) -> int:
    if kind in _VARINT:
        return 0
    if kind == "double":
        return 1
    if kind == "float":
        return 5
    return 2


def _skip(buf, pos: int, wt: int) -> int:
    if wt == 0:
        return _read_varint(buf, pos)[1]
    if wt == 1:
        return pos + 8
    if wt == 5:
        return pos + 4
    if wt == 2:
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wt == 3:                     # a group: skip to its end tag
        while True:
            tag, pos = _read_varint(buf, pos)
            if tag & 7 == 4:
                return pos
            pos = _skip(buf, pos, tag & 7)
    raise DecodeError(f"bad wire type {wt}")


# -- containers ----------------------------------------------------------------

class _Repeated(list):
    """A repeated scalar field (a list); writes mark the owner present."""

    def __init__(self, owner):
        super().__init__()
        self._owner = owner

    def append(self, v):
        super().append(v)
        self._owner._touch()

    def extend(self, vs):
        super().extend(vs)
        self._owner._touch()


class _RepeatedMessage(list):
    """A repeated message field: ``add()`` appends a new element."""

    def __init__(self, owner, cls):
        super().__init__()
        self._owner = owner
        self._cls = cls

    def add(self, **kw):
        m = self._cls(**kw)
        super().append(m)
        self._owner._touch()
        return m


class _Map(dict):
    """A map field; ``m[key]`` on a missing key creates its default value
    (an empty message, or the scalar default)."""

    def __init__(self, owner, value_kind, value_cls):
        super().__init__()
        self._owner = owner
        self._kind = value_kind
        self._cls = value_cls

    def __missing__(self, key):
        v = self._cls() if self._kind == "message" else _DEFAULTS[self._kind]
        if self._kind == "message":
            v._parent = self._owner
        self[key] = v
        self._owner._touch()
        return v


# -- messages ------------------------------------------------------------------

class _Field:
    __slots__ = ("name", "number", "kind", "repeated", "oneof", "cls", "map_kinds",
                 "view")

    def __init__(self, name, number, kind, repeated=False, oneof=None, cls=None,
                 map_kinds=None, view=False):
        self.name, self.number, self.kind = name, number, kind
        self.repeated, self.oneof, self.cls = repeated, oneof, cls
        self.map_kinds = map_kinds      # (key kind, value kind) of a map field
        self.view = view                # bytes parsed as a memoryview


_CLASSES: dict = {}


class Message:
    """Base of the subset's messages; see the module docstring."""

    _FIELDS: tuple = ()

    def __init__(self, **kw):
        object.__setattr__(self, "_v", {})
        object.__setattr__(self, "_present", False)
        object.__setattr__(self, "_parent", None)
        object.__setattr__(self, "_which", {})
        for k, v in kw.items():
            setattr(self, k, v)

    # presence: writing anything into a message makes it (and its parents) present
    def _touch(self) -> None:
        m = self
        while m is not None and not m._present:
            object.__setattr__(m, "_present", True)
            m = m._parent

    @classmethod
    def _field(cls, name: str) -> _Field:
        f = cls._BY_NAME.get(name)
        if f is None:
            raise AttributeError(f"{cls.__name__} has no field {name!r}")
        return f

    def _container(self, f: _Field):
        c = self._v.get(f.name)
        if c is None:
            if f.map_kinds is not None:
                c = _Map(self, f.map_kinds[1], _resolve(f.cls))
            elif f.kind == "message":
                c = _RepeatedMessage(self, _resolve(f.cls))
            else:
                c = _Repeated(self)
            self._v[f.name] = c
        return c

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        f = type(self)._field(name)
        if f.repeated:
            return self._container(f)
        if name in self._v:
            return self._v[name]
        if f.kind == "message":
            m = _resolve(f.cls)()
            object.__setattr__(m, "_parent", self)
            self._v[name] = m
            return m
        return _DEFAULTS[f.kind]

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        f = type(self)._field(name)
        if f.repeated or f.kind == "message":
            raise AttributeError(f"assignment to {name!r} is not allowed; "
                                 "use CopyFrom, add() or extend()")
        if f.kind in ("int32", "int64", "uint32", "uint64", "enum"):
            value = int(value)
        elif f.kind == "bool":
            value = bool(value)
        elif f.kind in ("float", "double"):
            value = float(value)
        elif f.kind == "string" and isinstance(value, bytes):
            value = value.decode()
        self._v[name] = value
        if f.oneof is not None:
            self._select(f)
        self._touch()

    def _select(self, f: _Field) -> None:
        prior = self._which.get(f.oneof)
        if prior is not None and prior != f.name:
            self._v.pop(prior, None)
        self._which[f.oneof] = f.name

    def WhichOneof(self, group: str):
        name = self._which.get(group)
        if name is None:
            # a oneof message member becomes the choice once written to
            for f in self._FIELDS:
                if f.oneof == group and f.kind == "message":
                    m = self._v.get(f.name)
                    if m is not None and m._present:
                        self._select(f)
                        return f.name
        return name

    def _has(self, f: _Field) -> bool:
        if f.oneof is not None:
            return self.WhichOneof(f.oneof) == f.name
        if f.repeated:
            return bool(self._v.get(f.name))
        v = self._v.get(f.name)
        if f.kind == "message":
            return v is not None and v._present
        return v is not None and v != _DEFAULTS[f.kind]

    # -- copying and comparing -----------------------------------------------
    def CopyFrom(self, other: "Message") -> None:
        if type(other) is not type(self):
            raise TypeError(f"CopyFrom {type(other).__name__} into {type(self).__name__}")
        if other is self:
            return
        self._v.clear()
        self._which.clear()
        self.MergeFrom(other)
        self._touch()

    def MergeFrom(self, other: "Message") -> None:
        for f in self._FIELDS:
            src = other._v.get(f.name)
            if src is None:
                continue
            if f.map_kinds is not None:
                dst = self._container(f)
                for k, v in src.items():
                    if f.map_kinds[1] == "message":
                        dst[k].MergeFrom(v)
                    else:
                        dst[k] = v
            elif f.repeated and f.kind == "message":
                dst = self._container(f)
                for m in src:
                    dst.add().MergeFrom(m)
            elif f.repeated:
                self._container(f).extend(src)
            elif f.kind == "message":
                if src._present:
                    sub = getattr(self, f.name)
                    sub.MergeFrom(src)
                    sub._touch()
                    if f.oneof is not None:
                        self._select(f)
            elif f.oneof is None or other._which.get(f.oneof) == f.name:
                setattr(self, f.name, src)

    def _canon(self):
        out = []
        for f in self._FIELDS:
            if not self._has(f):
                continue
            v = self._v.get(f.name)
            if f.map_kinds is not None:
                items = sorted(v.items())
                v = tuple((k, x._canon() if f.map_kinds[1] == "message" else x)
                          for k, x in items)
            elif f.repeated and f.kind == "message":
                v = tuple(m._canon() for m in v)
            elif f.repeated:
                v = tuple(bytes(x) if isinstance(x, memoryview) else x for x in v)
            elif f.kind == "message":
                v = v._canon()
            elif isinstance(v, memoryview):
                v = bytes(v)
            out.append((f.name, v))
        return tuple(out)

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return self._canon() == other._canon()

    def __repr__(self):
        return f"{type(self).__name__}({dict(self._canon())!r})"

    # -- encoding --------------------------------------------------------------
    def SerializeToString(self) -> bytes:
        chunks: list = []
        self._encode(chunks)
        return b"".join(chunks)

    def _encode(self, chunks: list) -> int:
        """Append this message's encoding to ``chunks``; returns its length."""
        n = 0
        for f in self._FIELDS:
            if not self._has(f):
                continue
            v = self._v[f.name]
            if f.map_kinds is not None:
                kk, vk = f.map_kinds
                vcls = _resolve(f.cls) if vk == "message" else None
                for key, val in v.items():
                    entry: list = []
                    m = _encode_field(entry, 1, kk, key)
                    m += (_encode_message_field(entry, 2, val) if vcls is not None
                          else _encode_field(entry, 2, vk, val))
                    n += _emit_len(chunks, f.number, entry, m)
            elif f.repeated and f.kind in _PACKABLE:
                body = b"".join(_encode_scalar(f.kind, x) for x in v)
                n += _emit_len(chunks, f.number, [body], len(body))
            elif f.repeated:
                for x in v:
                    if f.kind == "message":
                        n += _encode_message_field(chunks, f.number, x)
                    else:
                        n += _encode_field(chunks, f.number, f.kind, x)
            elif f.kind == "message":
                n += _encode_message_field(chunks, f.number, v)
            else:
                n += _encode_field(chunks, f.number, f.kind, v)
        return n

    # -- decoding --------------------------------------------------------------
    def ParseFromString(self, data) -> int:
        self._v.clear()
        self._which.clear()
        mv = memoryview(data)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        self._decode(mv, 0, len(mv))
        return len(mv)

    def _decode(self, buf, pos: int, end: int) -> None:
        by_num = self._BY_NUM
        while pos < end:
            tag, pos = _read_varint(buf, pos)
            num, wt = tag >> 3, tag & 7
            if num == 0:
                raise DecodeError("field number 0")
            f = by_num.get(num)
            if f is None:
                pos = _skip(buf, pos, wt)
                continue
            if wt == 2:
                ln, pos = _read_varint(buf, pos)
                stop = pos + ln
                if stop > end:
                    raise DecodeError(f"{f.name}: length past the end of the message")
                self._decode_len(f, buf, pos, stop)
                pos = stop
            elif wt == _wire_type(f.kind) and f.kind in _PACKABLE:
                if wt == 0:
                    raw, pos = _read_varint(buf, pos)
                    val = _from_varint(f.kind, raw)
                elif wt == 5:
                    val = struct.unpack_from("<f", buf, pos)[0]
                    pos += 4
                else:
                    val = struct.unpack_from("<d", buf, pos)[0]
                    pos += 8
                if f.repeated:
                    list.append(self._container(f), val)
                else:
                    self._v[f.name] = val
                    if f.oneof is not None:
                        self._select(f)
            else:
                raise DecodeError(f"{type(self).__name__}.{f.name}: wire type {wt}")
        object.__setattr__(self, "_present", True)

    def _decode_len(self, f: _Field, buf, pos: int, stop: int) -> None:
        if f.map_kinds is not None:
            kk, vk = f.map_kinds
            key, val = _DEFAULTS[kk], None
            p = pos
            while p < stop:
                tag, p = _read_varint(buf, p)
                num, wt = tag >> 3, tag & 7
                if num == 1 and wt == 2:
                    ln, p = _read_varint(buf, p)
                    key = bytes(buf[p:p + ln]).decode()
                    p += ln
                elif num == 2 and wt == 2:
                    ln, p = _read_varint(buf, p)
                    if vk == "message":
                        val = _resolve(f.cls)()
                        val._decode(buf, p, p + ln)
                    else:
                        val = bytes(buf[p:p + ln]).decode()
                    p += ln
                else:
                    p = _skip(buf, p, wt)
            dst = self._container(f)
            if val is None:
                val = _resolve(f.cls)() if vk == "message" else _DEFAULTS[vk]
            if vk == "message":
                object.__setattr__(val, "_parent", self)
            dict.__setitem__(dst, key, val)
            return
        if f.kind == "message":
            m = _resolve(f.cls)()
            m._decode(buf, pos, stop)
            object.__setattr__(m, "_parent", self)
            if f.repeated:
                list.append(self._container(f), m)
            else:
                self._v[f.name] = m
                if f.oneof is not None:
                    self._select(f)
            return
        if f.kind in _PACKABLE:                 # packed repeated scalars
            dst = self._container(f)
            if f.kind == "float":
                list.extend(dst, struct.unpack_from(f"<{(stop - pos) // 4}f", buf, pos))
            elif f.kind == "double":
                list.extend(dst, struct.unpack_from(f"<{(stop - pos) // 8}d", buf, pos))
            else:
                p = pos
                while p < stop:
                    raw, p = _read_varint(buf, p)
                    list.append(dst, _from_varint(f.kind, raw))
            return
        if f.kind == "string":
            val = bytes(buf[pos:stop]).decode()
        elif f.view:
            val = buf[pos:stop]
        else:
            val = bytes(buf[pos:stop])
        if f.repeated:
            list.append(self._container(f), val)
        else:
            self._v[f.name] = val
            if f.oneof is not None:
                self._select(f)


def _emit_len(chunks: list, number: int, body: list, n: int) -> int:
    head = _varint((number << 3) | 2) + _varint(n)
    chunks.append(head)
    chunks.extend(body)
    return len(head) + n


def _encode_field(chunks: list, number: int, kind: str, v) -> int:
    if kind == "string":
        b = v.encode()
        return _emit_len(chunks, number, [b], len(b))
    if kind == "bytes":
        return _emit_len(chunks, number, [v], len(v))
    b = _varint((number << 3) | _wire_type(kind)) + _encode_scalar(kind, v)
    chunks.append(b)
    return len(b)


def _encode_message_field(chunks: list, number: int, m: Message) -> int:
    body: list = []
    n = m._encode(body)
    return _emit_len(chunks, number, body, n)


def _resolve(cls):
    return _CLASSES[cls] if isinstance(cls, str) else cls


def _define(name: str, fields: list) -> type:
    fs = tuple(sorted((_Field(*f[:3], **(f[3] if len(f) > 3 else {})) for f in fields),
                      key=lambda f: f.number))
    cls = type(name, (Message,), {
        "_FIELDS": fs,
        "_BY_NAME": {f.name: f for f in fs},
        "_BY_NUM": {f.number: f for f in fs},
    })
    _CLASSES[name] = cls
    return cls


_R = {"repeated": True}

TensorShapeProto = _define("TensorShapeProto", [
    ("dim", 2, "message", {"repeated": True, "cls": "TensorShapeProto.Dim"}),
    ("unknown_rank", 3, "bool"),
])
TensorShapeProto.Dim = _define("TensorShapeProto.Dim", [
    ("size", 1, "int64"), ("name", 2, "string")])

TensorProto = _define("TensorProto", [
    ("dtype", 1, "enum"),
    ("tensor_shape", 2, "message", {"cls": "TensorShapeProto"}),
    ("version_number", 3, "int32"),
    ("tensor_content", 4, "bytes", {"view": True}),
    ("half_val", 13, "int32", _R), ("float_val", 5, "float", _R),
    ("double_val", 6, "double", _R), ("int_val", 7, "int32", _R),
    ("string_val", 8, "bytes", _R), ("scomplex_val", 9, "float", _R),
    ("int64_val", 10, "int64", _R), ("bool_val", 11, "bool", _R),
    ("uint32_val", 16, "uint32", _R), ("uint64_val", 17, "uint64", _R),
])

_V = "value"
AttrValue = _define("AttrValue", [
    ("s", 2, "bytes", {"oneof": _V}), ("i", 3, "int64", {"oneof": _V}),
    ("f", 4, "float", {"oneof": _V}), ("b", 5, "bool", {"oneof": _V}),
    ("type", 6, "enum", {"oneof": _V}),
    ("shape", 7, "message", {"oneof": _V, "cls": "TensorShapeProto"}),
    ("tensor", 8, "message", {"oneof": _V, "cls": "TensorProto"}),
    ("list", 1, "message", {"oneof": _V, "cls": "AttrValue.ListValue"}),
    ("placeholder", 9, "string", {"oneof": _V}),
    ("func", 10, "message", {"oneof": _V, "cls": "NameAttrList"}),
])
AttrValue.ListValue = _define("AttrValue.ListValue", [
    ("s", 2, "bytes", _R), ("i", 3, "int64", _R), ("f", 4, "float", _R),
    ("b", 5, "bool", _R), ("type", 6, "enum", _R),
    ("shape", 7, "message", {"repeated": True, "cls": "TensorShapeProto"}),
    ("tensor", 8, "message", {"repeated": True, "cls": "TensorProto"}),
])


def _attr_map(number: int) -> tuple:
    return ("attr", number, "message",
            {"repeated": True, "cls": "AttrValue", "map_kinds": ("string", "message")})


NameAttrList = _define("NameAttrList", [("name", 1, "string"), _attr_map(2)])
NodeDef = _define("NodeDef", [
    ("name", 1, "string"), ("op", 2, "string"), ("input", 3, "string", _R),
    ("device", 4, "string"), _attr_map(5)])
VersionDef = _define("VersionDef", [("producer", 1, "int32"), ("min_consumer", 2, "int32")])
OpDef = _define("OpDef", [
    ("name", 1, "string"),
    ("input_arg", 2, "message", {"repeated": True, "cls": "OpDef.ArgDef"}),
    ("output_arg", 3, "message", {"repeated": True, "cls": "OpDef.ArgDef"}),
])
OpDef.ArgDef = _define("OpDef.ArgDef", [
    ("name", 1, "string"), ("description", 2, "string"), ("type", 3, "enum"),
    ("type_attr", 4, "string")])
_STR_MAP = {"repeated": True, "map_kinds": ("string", "string")}
FunctionDef = _define("FunctionDef", [
    ("signature", 1, "message", {"cls": "OpDef"}),
    ("node_def", 3, "message", {"repeated": True, "cls": "NodeDef"}),
    ("ret", 4, "string", _STR_MAP), _attr_map(5),
    ("control_ret", 6, "string", _STR_MAP),
])
FunctionDefLibrary = _define("FunctionDefLibrary", [
    ("function", 1, "message", {"repeated": True, "cls": "FunctionDef"})])
GraphDef = _define("GraphDef", [
    ("node", 1, "message", {"repeated": True, "cls": "NodeDef"}),
    ("library", 2, "message", {"cls": "FunctionDefLibrary"}),
    ("versions", 4, "message", {"cls": "VersionDef"}),
])
