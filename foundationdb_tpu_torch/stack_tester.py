"""Stack-machine API tester (ref: bindings/bindingtester — generated
stack programs run against every language binding, results diffed across
them; the spec is bindings/bindingtester/spec/bindingApiTester.md).

One interpreter executes tagged instruction streams against the REAL
client API; a second executes the same stream against the in-memory model
(workloads.api_correctness.ModelKV with a serial commit discipline).
Equal final stacks + equal final database contents = the binding surface
implements the spec. The generator produces seeded random programs, so
this doubles as an API fuzzer (ref: the bindingtester's generators).

Instructions (subset of the spec, same names):
  PUSH <v> / DUP / SWAP / POP / SUB / CONCAT
  TUPLE_PACK <n> / TUPLE_UNPACK / TUPLE_RANGE <n>
  NEW_TRANSACTION / SET / CLEAR / CLEAR_RANGE / ATOMIC_OP <op>
  GET / GET_RANGE / COMMIT / RESET
"""

from __future__ import annotations

from typing import Optional

from .layers import tuple as tuplelayer
from .kv.atomic import MutationType
from .workloads.api_correctness import ModelKV


class StackTester:
    """Executes one program against a Database, mirroring every mutation
    into a model; `check()` compares final stack and data."""

    def __init__(self, db, prefix: bytes = b"st/"):
        self.db = db
        self.prefix = prefix
        self.stack: list = []
        self.model = ModelKV()
        self._staged: Optional[ModelKV] = None
        self.tr = None

    def _push(self, v) -> None:
        self.stack.append(v)

    def _pop(self, n: int = 1):
        out = [self.stack.pop() for _ in range(n)]
        return out[0] if n == 1 else out

    async def run(self, program) -> None:
        for instr in program:
            op, args = instr[0], instr[1:]
            await self._step(op, args)

    async def _step(self, op: str, args) -> None:
        db, model = self.db, self.model
        if op == "PUSH":
            self._push(args[0])
        elif op == "DUP":
            self._push(self.stack[-1])
        elif op == "SWAP":
            i = self._pop()
            self.stack[-1 - i], self.stack[-1] = (
                self.stack[-1], self.stack[-1 - i]
            )
        elif op == "POP":
            self._pop()
        elif op == "SUB":
            b, a = self._pop(), self._pop()
            self._push(a - b)
        elif op == "CONCAT":
            b, a = self._pop(), self._pop()
            self._push(a + b)
        elif op == "TUPLE_PACK":
            items = [self._pop() for _ in range(args[0])]
            self._push(self.prefix + tuplelayer.pack(tuple(reversed(items))))
        elif op == "TUPLE_UNPACK":
            packed = self._pop()
            for item in tuplelayer.unpack(packed[len(self.prefix):]):
                self._push(item)
        elif op == "TUPLE_RANGE":
            items = [self._pop() for _ in range(args[0])]
            b, e = tuplelayer.range_of(tuple(reversed(items)))
            self._push(self.prefix + b)
            self._push(self.prefix + e)
        elif op == "NEW_TRANSACTION":
            self.tr = db.create_transaction()
            self._staged = self.model.clone()
        elif op == "SET":
            v, k = self._pop(), self._pop()
            self.tr.set(k, v)
            self._staged.set(k, v)
        elif op == "CLEAR":
            k = self._pop()
            self.tr.clear(k)
            self._staged.clear_range(k, k + b"\x00")
        elif op == "CLEAR_RANGE":
            e, b = self._pop(), self._pop()
            self.tr.clear_range(b, e)
            self._staged.clear_range(b, e)
        elif op == "ATOMIC_OP":
            v, k = self._pop(), self._pop()
            self.tr.atomic_op(args[0], k, v)
            self._staged.atomic(args[0], k, v)
        elif op == "GET":
            k = self._pop()
            got = await self.tr.get(k)
            want = self._staged.get(k)
            assert got == want, f"GET {k!r}: api={got!r} model={want!r}"
            self._push(got if got is not None else b"RESULT_NOT_PRESENT")
        elif op == "GET_RANGE":
            e, b = self._pop(), self._pop()
            got = await self.tr.get_range(b, e)
            want = self._staged.get_range(b, e)
            assert got == want, f"GET_RANGE {b!r}..{e!r}: {got} != {want}"
            self._push(len(got))
        elif op == "COMMIT":
            await self.tr.commit()
            self.model = self._staged
            self.tr = None
        elif op == "RESET":
            self.tr.reset()
            self._staged = self.model.clone()
        else:
            raise ValueError(f"unknown instruction {op}")

    async def check(self) -> bool:
        """Final database contents must equal the model's."""
        async def body(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff")

        rows = await self.db.transact(body)
        want = self.model.get_range(self.prefix, self.prefix + b"\xff")
        return rows == want


def generate_program(rng, n_txns: int = 5, ops_per_txn: int = 8,
                     key_space: int = 12):
    """Seeded random program in the spec's instruction set (ref: the
    bindingtester generators)."""
    prog = []
    atomics = [MutationType.ADD_VALUE, MutationType.BYTE_MAX,
               MutationType.BYTE_MIN, MutationType.OR]

    def push_key():
        # Stack order: pushes reversed by TUPLE_PACK -> tuple ("k", n),
        # so TUPLE_RANGE over ("k",) covers every generated key.
        prog.append(("PUSH", "k"))
        prog.append(("PUSH", rng.randrange(key_space)))
        prog.append(("TUPLE_PACK", 2))

    for _ in range(n_txns):
        prog.append(("NEW_TRANSACTION",))
        for _ in range(rng.randrange(1, ops_per_txn)):
            roll = rng.random()
            if roll < 0.35:
                push_key()
                prog.append(("PUSH", b"v%d" % rng.randrange(1000)))
                prog.append(("SET",))
            elif roll < 0.5:
                push_key()
                prog.append(("GET",))
                prog.append(("POP",))
            elif roll < 0.62:
                push_key()
                prog.append(("CLEAR",))
            elif roll < 0.72:
                prog.append(("PUSH", "k"))
                prog.append(("TUPLE_RANGE", 1))
                prog.append(("GET_RANGE",))
                prog.append(("POP",))
            elif roll < 0.85:
                push_key()
                prog.append(
                    ("PUSH", rng.randrange(256).to_bytes(8, "little"))
                )
                prog.append(("ATOMIC_OP", rng.choice(atomics)))
            else:
                a, b = rng.randrange(key_space), rng.randrange(key_space)
                lo, hi = min(a, b), max(a, b) + 1
                prog.append(("PUSH", "k"))
                prog.append(("PUSH", lo))
                prog.append(("TUPLE_PACK", 2))
                prog.append(("PUSH", "k"))
                prog.append(("PUSH", hi))
                prog.append(("TUPLE_PACK", 2))
                prog.append(("CLEAR_RANGE",))
        prog.append(("COMMIT",))
    return prog
