"""The port's whole slice: ConflictSetGPU (on the CPU) against the JAX
package's ConflictSetTPU and the oracle ConflictSetCPU.

Same numpy-seeded batches into all three; statuses, entries() and
last_p2_iters must be equal after every batch, across GC, intra-batch
abort chains, key-width growth, capacity growth and forced compactions
(the compaction knob set low in both packages), through the object and
the wire paths, pipelined and out of order, and across a mid-stream
hand-over of a ConflictSetTPU's state to ConflictSetGPU.from_state.
"""

import struct

import numpy as np
import pytest
import torch

from foundationdb_tpu.core.knobs import SERVER_KNOBS as JKNOBS
from foundationdb_tpu.kv.keys import KeyRange as JKeyRange
from foundationdb_tpu.resolver.cpu import ConflictSetCPU
from foundationdb_tpu.resolver.tpu import ConflictSetTPU
from foundationdb_tpu.resolver.types import TxnConflictInfo as JTxn
from foundationdb_tpu.resolver.wire import WireBatch as JWire
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS as PKNOBS
from foundationdb_tpu_torch.kv.keys import KeyRange as PKeyRange
from foundationdb_tpu_torch.resolver.cpu import ConflictSetCPU as PortOracle
from foundationdb_tpu_torch.resolver import gpu
from foundationdb_tpu_torch.resolver.factory import make_conflict_set
from foundationdb_tpu_torch.resolver.gpu import ConflictSetGPU
from foundationdb_tpu_torch.resolver.types import TxnConflictInfo as PTxn
from foundationdb_tpu_torch.resolver.wire import WireBatch as PWire


def key(a: int, wide: bool = False) -> bytes:
    k = struct.pack(">Q", int(a))
    return b"wide/" * 4 + k if wide else k


def raw_batch(rng, n, version, space=250, lag=500, wide=False, chain=0,
              braid=0):
    """Random point/range reads and writes, optionally one abort chain
    (t reads what t-1 wrote), one braid (t reads what t-1 AND t-2 wrote:
    two potential writers per read, so phase 2's pointer-jumping seed is
    inexact and verification rounds repair it) and 28-byte keys (width
    growth)."""
    out = []
    for i in range(chain):
        a, b = 5 + 11 * i, 5 + 11 * (i + 1)
        out.append((version - 1, [(key(a), key(a) + b"\x00")],
                    [(key(b), key(b) + b"\x00")]))
    for i in range(braid):
        lo, me = 3000 + 10 * (i - 2), 3000 + 10 * i
        out.append((version - 1, [(key(lo), key(me - 5))],
                    [(key(me), key(me) + b"\x00")]))
    for _ in range(n):
        rr = [(key(a, wide), key(a + int(rng.integers(1, 6)), wide))
              for a in map(int, rng.integers(0, space, rng.integers(0, 4)))]
        wr = [(key(a, wide), key(a, wide) + b"\x00")
              for a in map(int, rng.integers(0, space, rng.integers(0, 3)))]
        out.append((version - int(rng.integers(0, lag)), rr, wr))
    return out


def txns(raw, jax_side: bool):
    T, KR = (JTxn, JKeyRange) if jax_side else (PTxn, PKeyRange)
    return [T(s, [KR(*r) for r in rr], [KR(*w) for w in wr])
            for s, rr, wr in raw]


@pytest.fixture
def low_compaction(monkeypatch):
    monkeypatch.setattr(JKNOBS, "TPU_COMPACT_EVERY_BATCHES", 3)
    monkeypatch.setattr(PKNOBS, "TPU_COMPACT_EVERY_BATCHES", 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slice_matches_tpu_and_oracle(seed, low_compaction):
    rng = np.random.default_rng(seed)
    ora = ConflictSetCPU()
    tpu = ConflictSetTPU(max_key_bytes=8, initial_capacity=64)
    port = ConflictSetGPU(max_key_bytes=8, initial_capacity=64, device="cpu")
    v = 1000
    # Large batches grow the capacity; small ones fit the blocks' headroom
    # and take the batch-scaled path between compactions.
    for b, n in enumerate((50, 70, 90, 10, 12, 60, 10, 12, 10)):
        v += 100
        raw = raw_batch(rng, n, v, wide=(b == 5), chain=6 * (b % 2),
                        braid=12 * (b % 3 == 2))
        no = v - 700
        want = ora.resolve(v, no, txns(raw, True)).statuses
        if b in (3, 7):  # the wire path on both sides
            got_t = tpu.resolve(v, no, JWire.from_txns(txns(raw, True)))
            got_p = port.resolve(v, no, PWire.from_txns(txns(raw, False)))
        else:
            got_t = tpu.resolve(v, no, txns(raw, True))
            got_p = port.resolve(v, no, txns(raw, False))
        assert got_t.statuses == want, f"batch {b}"
        assert got_p.statuses == want, f"batch {b}"
        assert port.last_p2_iters == tpu.last_p2_iters, f"batch {b}"
        assert port.entries() == ora.entries(), f"batch {b}"
    assert tpu.entries() == ora.entries()
    # The run grew the width and the capacity and took both paths.
    assert port.max_key_bytes == tpu.max_key_bytes > 8
    assert port.capacity == tpu.capacity > 64
    assert port.compactions > 0 and port.fast_resolves > 0


def test_pipelined_out_of_order_and_double_consume(low_compaction):
    rng = np.random.default_rng(5)
    ora = ConflictSetCPU()
    windows, v = [], 1000
    for b in range(10):
        v += 100
        windows.append((v, raw_batch(rng, 30, v, chain=3)))
    want = [ora.resolve(v, v - 600, txns(r, True)).statuses for v, r in windows]

    port = ConflictSetGPU(max_key_bytes=8, initial_capacity=64, device="cpu")
    handles, got = [], []
    for v, raw in windows[:6]:
        if len(handles) >= 4:
            got.append(port.verdicts(handles.pop(0)))
        handles.append(port.submit(v, v - 600, txns(raw, False)))
        assert port.inflight == len(handles)
    while handles:
        got.append(port.verdicts(handles.pop(0)))
    assert port.max_inflight == 4
    # The rest submitted together, consumed newest first.
    handles = [port.submit(v, v - 600, txns(r, False)) for v, r in windows[6:]]
    assert all(h.p2_syncs >= 1 for h in handles)
    got.extend(reversed([port.verdicts(h) for h in reversed(handles)]))
    assert got == want
    assert port.inflight == 0
    assert port.entries() == ora.entries()
    with pytest.raises(RuntimeError):
        port.verdicts(handles[0])


def test_chunked_submit_matches_oracle(low_compaction, monkeypatch):
    """Batches split into many chunks (both caps low), through the object
    and the wire path: chunks resolved at one version equal one batch."""
    monkeypatch.setattr(PKNOBS, "TPU_MAX_CHUNK_TXNS", 16)
    monkeypatch.setattr(PKNOBS, "TPU_MAX_CHUNK_RANGES", 40)
    rng = np.random.default_rng(21)
    ora = ConflictSetCPU()
    port = ConflictSetGPU(max_key_bytes=8, initial_capacity=256, device="cpu")
    v = 1000
    for b in range(6):
        v += 100
        raw = raw_batch(rng, 70, v, chain=5, braid=6 * (b % 2))
        want = ora.resolve(v, v - 600, txns(raw, True)).statuses
        batch = (PWire.from_txns(txns(raw, False)) if b % 2
                 else txns(raw, False))
        h = port.submit(v, v - 600, batch)
        assert len(h.chunks) >= 5
        assert port.verdicts(h) == want, f"batch {b}"
    assert port.entries() == ora.entries()
    assert port.fast_resolves > 0


def test_hand_over_mid_stream_from_tpu_state(low_compaction):
    """Three batches on ConflictSetTPU, its state handed to
    ConflictSetGPU.from_state, three more on both: identical."""
    rng = np.random.default_rng(9)
    tpu = ConflictSetTPU(max_key_bytes=8, initial_capacity=64)
    v = 1000
    for _ in range(3):
        v += 100
        tpu.resolve(v, v - 500, txns(raw_batch(rng, 40, v, chain=4), True))
    tpu._refresh_mirror()
    state = {
        "hmat": np.asarray(tpu.hmat), "counts": np.asarray(tpu.counts),
        "fences": np.asarray(tpu.fences), "btree": np.asarray(tpu.btree),
        "n": int(tpu.n), "NB": tpu.NB, "B": tpu.B, "n_words": tpu.n_words,
        "_base": tpu._base, "oldest_version": tpu.oldest_version,
        "_since_compact": tpu._since_compact,
        "_fences_enc": tpu._fences_enc, "_fills": tpu._fills,
        "min_NB": tpu.min_NB,
    }
    port = ConflictSetGPU.from_state(state, device="cpu")
    assert port.entries() == tpu.entries()
    for _ in range(3):
        v += 100
        raw = raw_batch(rng, 40, v, chain=4)
        a = tpu.resolve(v, v - 500, txns(raw, True)).statuses
        b = port.resolve(v, v - 500, txns(raw, False)).statuses
        assert a == b
        assert port.last_p2_iters == tpu.last_p2_iters
        assert port.entries() == tpu.entries()
        assert port._since_compact == tpu._since_compact


@pytest.mark.parametrize("groups", [(1,), (3,), (64,)])
def test_phase2_group_schedule_is_invisible(groups, monkeypatch):
    """The host-read cadence of phase 2's stopping rule changes nothing
    but the number of reads: verdicts, entries and round counts equal the
    oracle and the default schedule."""
    rng = np.random.default_rng(13)
    raws = [raw_batch(rng, 30, 1000 + 100 * b, chain=9, braid=24)
            for b in range(1, 4)]

    def run():
        cs = ConflictSetGPU(max_key_bytes=8, initial_capacity=64, device="cpu")
        out = [(cs.resolve(1000 + 100 * b, 600 + 100 * b,
                           txns(r, False)).statuses, cs.last_p2_iters)
               for b, r in enumerate(raws, 1)]
        return out, cs.entries()

    want = run()
    monkeypatch.setattr(gpu, "_P2_GROUPS", groups)
    syncs0 = gpu.P2_SYNCS
    assert run() == want
    assert gpu.P2_SYNCS > syncs0
    ora = ConflictSetCPU()
    assert [st for st, _ in want[0]] == [
        ora.resolve(1000 + 100 * b, 600 + 100 * b, txns(r, True)).statuses
        for b, r in enumerate(raws, 1)]
    assert want[1] == ora.entries()
    # 14+ verification rounds: the run crosses several group boundaries.
    assert min(it for _, it in want[0]) >= max((64 - 1).bit_length(), 1) + 14


def test_warmup_restores_state():
    rng = np.random.default_rng(17)
    ora = ConflictSetCPU()
    port = ConflictSetGPU(max_key_bytes=8, initial_capacity=128, device="cpu")
    v = 1000
    for b in range(4):
        v += 100
        raw = raw_batch(rng, 30, v)
        ora.resolve(v, v - 500, txns(raw, True))
        port.resolve(v, v - 500, txns(raw, False))
        if b == 1:
            before = port.entries()
            port.warmup(shapes=[(16, 32, 16), (64, 128, 64)])
            assert port.entries() == before
    assert port.entries() == ora.entries()


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ConflictSetGPU()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_conflict_set()
    with pytest.raises(RuntimeError, match="CUDA"):
        ConflictSetGPU.from_state({}, device="cuda")
    assert isinstance(make_conflict_set(impl="gpu", device="cpu"),
                      ConflictSetGPU)
    assert isinstance(make_conflict_set(impl="oracle"), PortOracle)
    with pytest.raises(ValueError):
        make_conflict_set(impl="native", device="cpu")
