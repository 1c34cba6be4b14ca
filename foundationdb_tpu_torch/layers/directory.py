"""Directory layer: hierarchical named namespaces over short allocated
prefixes (ref: bindings/python/fdb/directory_impl.py — DirectoryLayer,
HighContentionAllocator; design/tuple.md for the encoding it rides on).

Paths like ("app", "users") map to a short byte prefix allocated by the
HighContentionAllocator (HCA); the tree structure lives in a node
subspace keyed by prefix, with each node's children indexed under
SUBDIRS. API surface mirrors the reference binding:
create_or_open / open / create / move / remove / exists / list.

The HCA allocates prefixes many clients can claim concurrently without
conflicts: a `counters` subspace tracks the active allocation window; a
candidate id is picked RANDOMLY inside the window and claimed with a
conflict-free write + an explicit read-conflict-key on the candidate
only, so two concurrent allocations collide only when they pick the same
candidate (ref: HighContentionAllocator.allocate in directory_impl.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core.runtime import current_loop
from .subspace import Subspace
from .tuple import pack, unpack

SUBDIRS = 0
_LAYER_VERSION = (1, 0, 0)


class HighContentionAllocator:
    def __init__(self, subspace: Subspace):
        self.counters = subspace[0]
        self.recent = subspace[1]

    async def allocate(self, tr) -> bytes:
        """Returns a short byte string unique over this allocator's
        lifetime (ref: directory_impl.py HighContentionAllocator)."""
        loop = current_loop()
        while True:
            # Current window start = last counters entry.
            rows = await tr.get_range(
                self.counters.range()[0], self.counters.range()[1],
                limit=1, reverse=True, snapshot=True,
            )
            start = self.counters.unpack(rows[0][0])[0] if rows else 0

            window_advanced = False
            while True:
                candidates = await self._window_size(tr, start)
                count_key = self.counters.pack((start,))
                if window_advanced:
                    tr.clear_range(self.counters.key(), count_key)
                    tr.clear_range(
                        self.recent.key(), self.recent.pack((start,))
                    )
                # Count one allocation attempt in this window (atomic, so
                # concurrent allocators don't conflict here).
                tr.add(count_key, (1).to_bytes(8, "little"))
                raw = await tr.get(count_key, snapshot=True)
                count = int.from_bytes(raw or b"\x00", "little")
                if count * 2 < candidates:
                    break  # window has room
                start += candidates
                window_advanced = True

            # Pick a random candidate in [start, start+candidates).
            while True:
                candidate = start + loop.random.random_int(0, candidates)
                key = self.recent.pack((candidate,))
                latest = await tr.get_range(
                    self.counters.range()[0], self.counters.range()[1],
                    limit=1, reverse=True, snapshot=True,
                )
                latest_start = (
                    self.counters.unpack(latest[0][0])[0] if latest else 0
                )
                if latest_start > start:
                    break  # window moved under us: restart outer loop
                # NON-snapshot read: the read conflict on exactly this
                # candidate key is the collision detector — a concurrent
                # claimant's write of the same key aborts one of us, and
                # nothing else in the window conflicts (ref: the candidate
                # read in directory_impl.py allocate).
                taken = await tr.get(key)
                if taken is None:
                    tr.set(key, b"")
                    return pack((candidate,))

    async def _window_size(self, tr, start: int) -> int:
        from ..core.knobs import CLIENT_KNOBS

        base = CLIENT_KNOBS.HCA_WINDOW_INITIAL_SIZE
        if start < 255:
            return base
        if start < 65535:
            return base * 16
        return base * 256


class Directory:
    """A created directory: a Subspace plus its path + layer metadata."""

    def __init__(self, layer: "DirectoryLayer", path: tuple,
                 prefix: bytes, layer_tag: bytes = b""):
        self._layer = layer
        self.path = path
        self.layer_tag = layer_tag
        self.subspace = Subspace(raw_prefix=prefix)

    def key(self) -> bytes:
        return self.subspace.key()

    def pack(self, t=()) -> bytes:
        return self.subspace.pack(t)

    def range(self, t=()):
        return self.subspace.range(t)

    def __repr__(self):
        return f"Directory({'/'.join(map(str, self.path))!r}, {self.key()!r})"


class DirectoryLayer:
    def __init__(self, node_prefix: bytes = b"\xfe",
                 content_prefix: bytes = b""):
        self._nodes = Subspace(raw_prefix=node_prefix)
        self._content_prefix = content_prefix
        # The root node's entry lives at nodes[node_prefix].
        self._root = self._nodes[node_prefix]
        self._allocator = HighContentionAllocator(
            self._nodes[b"hca"]
        )

    # -- node helpers --
    def _node(self, prefix: bytes) -> Subspace:
        return self._nodes[prefix]

    async def _find(self, tr, path: Sequence) -> Optional[Subspace]:
        node = self._root
        for name in path:
            key = node[SUBDIRS].pack((name,))
            prefix = await tr.get(key)
            if prefix is None:
                return None
            node = self._node(prefix)
        return node

    async def _node_prefix(self, node: Subspace) -> bytes:
        # nodes[prefix] -> prefix is the last tuple element of the key.
        return self._nodes.unpack(node.key())[0]

    # -- public API (ref: directory_impl.py DirectoryLayer) --
    async def create_or_open(self, tr, path: Sequence, layer: bytes = b""
                             ) -> Directory:
        path = tuple(path)
        if not path:
            raise ValueError("the root directory cannot be opened this way")
        existing = await self._find(tr, path)
        if existing is not None:
            stored_layer = await tr.get(existing.pack((b"layer",)))
            if layer and stored_layer and stored_layer != layer:
                raise ValueError(
                    f"directory {path} exists with different layer "
                    f"{stored_layer!r}"
                )
            return Directory(
                self, path, await self._node_prefix(existing),
                stored_layer or b"",
            )
        return await self.create(tr, path, layer)

    async def create(self, tr, path: Sequence, layer: bytes = b"",
                     prefix: Optional[bytes] = None) -> Directory:
        path = tuple(path)
        if await self._find(tr, path) is not None:
            raise ValueError(f"directory {path} already exists")
        # Parent must exist (created recursively, like the reference).
        if len(path) > 1:
            await self.create_or_open(tr, path[:-1])
        parent = await self._find(tr, path[:-1]) if len(path) > 1 else self._root
        if prefix is None:
            prefix = self._content_prefix + await self._allocator.allocate(tr)
        node = self._node(prefix)
        tr.set(parent[SUBDIRS].pack((path[-1],)), prefix)
        tr.set(node.pack((b"layer",)), layer)
        return Directory(self, path, prefix, layer)

    async def open(self, tr, path: Sequence) -> Directory:
        node = await self._find(tr, tuple(path))
        if node is None:
            raise KeyError(f"directory {tuple(path)} does not exist")
        stored_layer = await tr.get(node.pack((b"layer",)))
        return Directory(
            self, tuple(path), await self._node_prefix(node),
            stored_layer or b"",
        )

    async def exists(self, tr, path: Sequence) -> bool:
        return await self._find(tr, tuple(path)) is not None

    async def list(self, tr, path: Sequence = ()) -> list:
        node = await self._find(tr, tuple(path)) if path else self._root
        if node is None:
            raise KeyError(f"directory {tuple(path)} does not exist")
        b, e = node[SUBDIRS].range()
        rows = await tr.get_range(b, e)
        return [node[SUBDIRS].unpack(k)[0] for k, _ in rows]

    async def move(self, tr, old_path: Sequence, new_path: Sequence
                   ) -> Directory:
        """Re-links the node under a new parent; contents keep their
        prefix (ref: directory move semantics)."""
        old_path, new_path = tuple(old_path), tuple(new_path)
        node = await self._find(tr, old_path)
        if node is None:
            raise KeyError(f"directory {old_path} does not exist")
        if await self._find(tr, new_path) is not None:
            raise ValueError(f"directory {new_path} already exists")
        new_parent = await self._find(tr, new_path[:-1]) if len(
            new_path
        ) > 1 else self._root
        if new_parent is None:
            raise KeyError(f"parent {new_path[:-1]} does not exist")
        prefix = await self._node_prefix(node)
        old_parent = await self._find(tr, old_path[:-1]) if len(
            old_path
        ) > 1 else self._root
        tr.clear(old_parent[SUBDIRS].pack((old_path[-1],)))
        tr.set(new_parent[SUBDIRS].pack((new_path[-1],)), prefix)
        return Directory(self, new_path, prefix)

    async def remove(self, tr, path: Sequence) -> None:
        """Removes the directory, its subtree, and ALL content under its
        prefixes (ref: remove's recursive subtree delete)."""
        path = tuple(path)
        node = await self._find(tr, path)
        if node is None:
            raise KeyError(f"directory {path} does not exist")
        await self._remove_subtree(tr, node)
        parent = await self._find(tr, path[:-1]) if len(path) > 1 else self._root
        tr.clear(parent[SUBDIRS].pack((path[-1],)))

    async def _remove_subtree(self, tr, node: Subspace) -> None:
        b, e = node[SUBDIRS].range()
        for k, child_prefix in await tr.get_range(b, e):
            await self._remove_subtree(tr, self._node(child_prefix))
        from ..kv.keys import strinc

        prefix = await self._node_prefix(node)
        # Content + node metadata. The end is strinc(prefix) — the first key
        # NOT prefixed — so raw suffixes starting with 0xff don't survive
        # removal (ref: the reference clears [prefix, strinc(prefix))).
        tr.clear_range(prefix, strinc(prefix))
        nb, ne = node.range()
        tr.clear_range(nb, ne)
        tr.clear(node.key())
