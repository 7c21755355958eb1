"""Minimal canonical CBOR (RFC 8949 subset) for structured artifacts.

The reference ships serde/CBOR round-trips for proofs and verification
keys (reference: src/serialization.rs:74-155 serde impls, :157-329 CBOR
round-trip + size tests).  This is the framework's equivalent
self-describing container; no third-party cbor package is assumed, so the
needed subset (unsigned ints, byte strings, text strings, arrays, maps)
is implemented directly.  Encoding is CANONICAL (RFC 8949 section 4.2):
shortest-form lengths and maps sorted by encoded key, so equal values
always produce identical bytes (stable for fixtures/hashing).
"""

from __future__ import annotations

from typing import Any

_MAJOR_UINT = 0
_MAJOR_BYTES = 2
_MAJOR_TEXT = 3
_MAJOR_ARRAY = 4
_MAJOR_MAP = 5


def _head(major: int, arg: int) -> bytes:
    assert arg >= 0
    mb = major << 5
    if arg < 24:
        return bytes([mb | arg])
    for ai, size in ((24, 1), (25, 2), (26, 4), (27, 8)):
        if arg < (1 << (8 * size)):
            return bytes([mb | ai]) + arg.to_bytes(size, "big")
    raise ValueError("CBOR argument too large for a single head")


def encode(value: Any) -> bytes:
    """Encode ints >= 0, bytes, str, list/tuple, dict (str keys)."""
    if isinstance(value, bool):
        raise TypeError("bool not in the supported CBOR subset")
    if isinstance(value, int):
        if value < 0:
            raise TypeError("negative ints not in the supported subset")
        return _head(_MAJOR_UINT, value)
    if isinstance(value, (bytes, bytearray)):
        return _head(_MAJOR_BYTES, len(value)) + bytes(value)
    if isinstance(value, str):
        b = value.encode("utf-8")
        return _head(_MAJOR_TEXT, len(b)) + b
    if isinstance(value, (list, tuple)):
        out = [_head(_MAJOR_ARRAY, len(value))]
        out += [encode(v) for v in value]
        return b"".join(out)
    if isinstance(value, dict):
        items = []
        for k, v in value.items():
            if not isinstance(k, str):
                raise TypeError("map keys must be str")
            items.append((encode(k), encode(v)))
        items.sort(key=lambda kv: kv[0])   # canonical: sort by encoded key
        out = [_head(_MAJOR_MAP, len(items))]
        for ek, ev in items:
            out.append(ek)
            out.append(ev)
        return b"".join(out)
    raise TypeError(f"unsupported CBOR type: {type(value)!r}")


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated CBOR")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def _head(self):
        b0 = self._take(1)[0]
        major, ai = b0 >> 5, b0 & 0x1F
        if ai < 24:
            return major, ai
        sizes = {24: 1, 25: 2, 26: 4, 27: 8}
        if ai not in sizes:
            raise ValueError(f"unsupported CBOR additional info {ai}")
        return major, int.from_bytes(self._take(sizes[ai]), "big")

    def decode(self):
        major, arg = self._head()
        if major == _MAJOR_UINT:
            return arg
        if major == _MAJOR_BYTES:
            return self._take(arg)
        if major == _MAJOR_TEXT:
            return self._take(arg).decode("utf-8")
        if major == _MAJOR_ARRAY:
            return [self.decode() for _ in range(arg)]
        if major == _MAJOR_MAP:
            out = {}
            for _ in range(arg):
                k = self.decode()
                if not isinstance(k, str):
                    raise ValueError("map keys must be text")
                out[k] = self.decode()
            return out
        raise ValueError(f"unsupported CBOR major type {major}")


def decode(data: bytes):
    d = _Decoder(data)
    value = d.decode()
    if d.pos != len(data):
        raise ValueError("trailing bytes after CBOR value")
    return value
