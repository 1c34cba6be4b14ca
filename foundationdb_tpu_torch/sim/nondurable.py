"""Nondurable simulated disk + durability validation (ref:
fdbrpc/AsyncFileNonDurable.actor.cpp — in simulation, a killed process's
un-fsynced writes are randomly dropped, kept, or corrupted, page by page;
fdbrpc/sim_validation.{h,cpp} — debug assertions that data a component
reported durable actually survives the kill).

`NonDurableOS` is an os-module-shaped layer (open/pread/pwrite/fsync/
ftruncate/fstat/close) over an in-memory page store: pwrites land in a
PENDING overlay; fsync promotes the file's overlay to durable; `kill()`
resolves every pending page by seeded coin flip — dropped, kept, or
corrupted — exactly the reference's page-granular havoc. Storage-engine
code takes the layer as a parameter, so the identical engine code runs on
the real os module in production and on this in simulation.

The port's copy of foundationdb_tpu/sim/nondurable.py: the same havoc
draws, in the same order, from the same seeded DeterministicRandom.
"""

from __future__ import annotations

from typing import Optional

PAGE = 4096


class _SimFile:
    def __init__(self):
        self.durable: dict[int, bytes] = {}   # page index -> 4K content
        self.pending: dict[int, bytes] = {}
        self.size = 0
        self.durable_size = 0


class SimValidationError(AssertionError):
    """A durability contract was violated (ref: sim_validation asserts)."""


class NonDurableOS:
    O_RDWR = 2
    O_CREAT = 64

    def __init__(self, random, drop_prob: float = 0.33,
                 corrupt_prob: float = 0.33):
        self.random = random
        self.drop_prob = drop_prob
        self.corrupt_prob = corrupt_prob
        self.files: dict[str, _SimFile] = {}
        self._fds: dict[int, _SimFile] = {}
        self._next_fd = 1000
        self.kills = 0

    # -- os-shaped API --
    def open(self, path: str, flags: int = 0, mode: int = 0o644) -> int:
        f = self.files.get(path)
        if f is None:
            f = self.files[path] = _SimFile()
        fd = self._next_fd
        self._next_fd += 1
        self._fds[fd] = f
        return fd

    def _page_read(self, f: _SimFile, idx: int) -> bytes:
        page = f.pending.get(idx)
        if page is None:
            page = f.durable.get(idx, b"\x00" * PAGE)
        return page

    def pread(self, fd: int, n: int, offset: int) -> bytes:
        f = self._fds[fd]
        out = bytearray()
        pos = offset
        end = min(offset + n, f.size)
        while pos < end:
            idx, off = divmod(pos, PAGE)
            take = min(PAGE - off, end - pos)
            out += self._page_read(f, idx)[off : off + take]
            pos += take
        return bytes(out)

    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        f = self._fds[fd]
        pos = offset
        i = 0
        while i < len(data):
            idx, off = divmod(pos, PAGE)
            take = min(PAGE - off, len(data) - i)
            page = bytearray(self._page_read(f, idx))
            page[off : off + take] = data[i : i + take]
            f.pending[idx] = bytes(page)
            pos += take
            i += take
        f.size = max(f.size, offset + len(data))
        return len(data)

    def fsync(self, fd: int) -> None:
        f = self._fds[fd]
        f.durable.update(f.pending)
        f.pending.clear()
        f.durable_size = f.size

    def ftruncate(self, fd: int, n: int) -> None:
        f = self._fds[fd]
        # Truncation is metadata: modeled as immediately durable (the
        # reference randomizes this too; conservative is fine — a LOST
        # truncate can only resurrect popped records, which recovery
        # tolerates, while a phantom truncate of synced data would not be).
        for idx in [i for i in f.durable if i * PAGE >= n]:
            del f.durable[idx]
        for idx in [i for i in f.pending if i * PAGE >= n]:
            del f.pending[idx]
        f.size = min(f.size, n)
        f.durable_size = min(f.durable_size, n)

    class _Stat:
        def __init__(self, size):
            self.st_size = size

    def fstat(self, fd: int):
        return self._Stat(self._fds[fd].size)

    def close(self, fd: int) -> None:
        self._fds.pop(fd, None)

    # -- the havoc (ref: AsyncFileNonDurable's kill behavior) --
    def kill(self, prefixes=None) -> dict:
        """The machine dies: every pending page is dropped, kept, or
        corrupted by seeded coin flip; open fds are gone.

        `prefixes` scopes the power loss to one MACHINE of a topology
        (sim/topology.py): only files whose path starts with one of the
        prefixes lose their pending pages — other machines' disks are a
        different failure domain and keep theirs. Open fds are cleared
        for the killed files only."""
        stats = {"dropped": 0, "kept": 0, "corrupted": 0}
        victims = {
            path: f for path, f in self.files.items()
            if prefixes is None
            or any(path.startswith(p) for p in prefixes)
        }
        for f in victims.values():
            for idx, page in list(f.pending.items()):
                roll = self.random.random01()
                if roll < self.drop_prob:
                    stats["dropped"] += 1
                elif roll < self.drop_prob + self.corrupt_prob:
                    mut = bytearray(page)
                    pos = self.random.random_int(0, PAGE)
                    mut[pos] ^= 0xFF
                    f.durable[idx] = bytes(mut)
                    stats["corrupted"] += 1
                else:
                    f.durable[idx] = page
                    stats["kept"] += 1
            f.pending.clear()
            f.size = max(
                f.durable_size,
                max(((i + 1) * PAGE for i in f.durable), default=0),
            )
        killed = set(map(id, victims.values()))
        for fd in [fd for fd, f in self._fds.items() if id(f) in killed]:
            del self._fds[fd]
        self.kills += 1
        return stats


class DurabilityValidator:
    """Tracks what a component REPORTED durable; after a kill+recover,
    `check_recovered` asserts all of it survived (ref: sim_validation's
    debugSetCheck / durability asserts across kills)."""

    def __init__(self):
        self._committed: list[bytes] = []

    def committed(self, payload: bytes) -> None:
        self._committed.append(payload)

    def check_recovered(self, recovered: list[bytes]) -> None:
        have = set(recovered)
        for payload in self._committed:
            if payload not in have:
                raise SimValidationError(
                    f"durability violation: committed record "
                    f"{payload[:40]!r}... lost across kill "
                    f"({len(self._committed)} committed, "
                    f"{len(recovered)} recovered)"
                )
