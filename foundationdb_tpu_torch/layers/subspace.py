"""Subspace: a key namespace rooted at a tuple prefix (ref:
fdbclient/Subspace.cpp; bindings/python/fdb/subspace_impl.py)."""

from __future__ import annotations

from typing import Any, Iterable

from . import tuple as tuple_layer


class Subspace:
    def __init__(self, prefix_tuple: Iterable[Any] = (), raw_prefix: bytes = b""):
        self.raw_prefix = raw_prefix + tuple_layer.pack(tuple(prefix_tuple))

    def key(self) -> bytes:
        return self.raw_prefix

    def pack(self, t: Iterable[Any] = ()) -> bytes:
        return self.raw_prefix + tuple_layer.pack(tuple(t))

    def unpack(self, key: bytes) -> tuple:
        if not self.contains(key):
            raise ValueError("key is not within this subspace")
        return tuple_layer.unpack(key[len(self.raw_prefix):])

    def contains(self, key: bytes) -> bool:
        return key.startswith(self.raw_prefix)

    def range(self, t: Iterable[Any] = ()) -> tuple[bytes, bytes]:
        """[begin, end) spanning every key packed under prefix + t."""
        p = self.raw_prefix + tuple_layer.pack(tuple(t))
        return p + b"\x00", p + b"\xff"

    def subspace(self, t: Iterable[Any]) -> "Subspace":
        return Subspace((), self.pack(t))

    def __getitem__(self, item: Any) -> "Subspace":
        return self.subspace((item,))

    def __repr__(self) -> str:
        return f"Subspace(raw_prefix={self.raw_prefix!r})"
