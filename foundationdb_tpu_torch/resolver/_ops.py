"""JAX idioms that torch lacks, one helper per semantic hazard.

The resolver's tensor functions (gpu.py) are line-for-line counterparts of
foundationdb_tpu/resolver/tpu.py, and every integer they produce must equal
the JAX package's bit for bit. Where the two frameworks differ in
semantics, the difference is handled here, once, and each helper names the
tpu.py sites that need it:

- scan dtype: torch.cumsum of int32 returns int64 unless told otherwise
  (tpu.py:498, 521, 567-569 and every other cumsum);
- out-of-bounds scatter: JAX drops an update whose index is out of range
  (after wrapping a negative index once), torch raises (CPU) or faults
  (CUDA); scatters here go to a fresh buffer with an explicit dump slot
  (tpu.py:601-614 `.at[N3]`/`.at[C]`, and the decode/phase-2 scatters).
  The in-place state scatters of the block kernel (`hmat.at[:, C]` :888,
  `counts.at[NB]` :890, `btree.at[2*NB]` :901/:907) redirect their pad
  rows in block.py's plain version instead (its CUDA kernel skips them),
  so the resident state needs no dump column;
- gather clamping: JAX clamps an out-of-range gather index, torch faults;
  gpu.py clamps explicitly at every gather whose index is not in range
  by construction (the same sites where tpu.py clips);
- int64 indices: scatter_/scatter_reduce_/index_add_/index_copy_ take
  int64 index tensors only;
- bit length without clz: `_table_range_query` (tpu.py:185) needs
  floor(log2(x)), computed with integer shifts, never a float log2;
- order-independent scatters: where duplicate indices could carry
  different values, the JAX kernel scatters with `.max` into a dump slot
  (tpu.py:595-614); CUDA index_put_ with duplicates is not deterministic,
  so the same reduction (amax/amin/add) is used here;
- int32 wrap: the increment end mode adds a carry to INT32_MAX and relies
  on two's-complement wrap (tpu.py:259); computed in int64, masked back;
- st_aux int8 bytes (tpu.py:914-920): bytes 128..255 become int8 by an
  explicit two's-complement mapping, not a cast of out-of-range int32.

The range helpers that gpu.py, compact.py, rankfed.py and phase2.py share
live here too: the lexicographic compare and the halving rank walk
(`_lex_lt_eq`, `_lower_rank`), the sparse range-query table
(`_build_table`, `_table_range_query`) and a segment tree's canonical
nodes (`_canonical_nodes_flat`); and the plain versions' small builders
that block.py, compact.py and gpu.py share (`_arange`, `_pad_col`, the
verdict bytes `st_aux_ref`).
"""

from __future__ import annotations

import torch

from .types import COMMITTED, CONFLICT, TOO_OLD

I32 = torch.int32
I64 = torch.int64
I32_INF = 2**31 - 1


def cumsum32(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inclusive prefix sum kept in int32 (JAX's cumsum of int32/bool)."""
    return torch.cumsum(x, dim=dim, dtype=I32)


def dump_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """JAX scatter index semantics as int64 indices into a buffer with one
    extra dump slot at `size`: a negative index wraps once, and whatever
    is still outside [0, size) lands in the dump slot."""
    idx = idx.to(I64)
    idx = torch.where(idx < 0, idx + size, idx)
    return torch.where((idx >= 0) & (idx < size), idx, size)


def scatter_new(size: int, fill: int, idx: torch.Tensor, src,
                op: str = "set") -> torch.Tensor:
    """`jnp.full(size, fill).at[idx].<op>(src)` for 1-D int32 buffers:
    op is set | add | max | min, out-of-range updates drop."""
    dev = idx.device
    buf = torch.full((size + 1,), fill, dtype=I32, device=dev)
    ix = dump_index(idx, size)
    if not torch.is_tensor(src):
        src = torch.full(ix.shape, src, dtype=I32, device=dev)
    src = src.to(I32)
    if op == "set":
        buf.index_copy_(0, ix, src)
    elif op == "add":
        buf.index_add_(0, ix, src)
    elif op == "max":
        buf.scatter_reduce_(0, ix, src, reduce="amax", include_self=True)
    elif op == "min":
        buf.scatter_reduce_(0, ix, src, reduce="amin", include_self=True)
    else:
        raise ValueError(f"unknown scatter op {op!r}")
    return buf[:size]


def scatter_cols_new(fill_col: torch.Tensor, size: int, idx: torch.Tensor,
                     src: torch.Tensor) -> torch.Tensor:
    """`jnp.broadcast_to(fill_col[:, None], (rows, size)).at[:, idx].set(src)`:
    column scatter into a fresh matrix, out-of-range columns drop. The
    caller keeps real destinations unique (only the dump slot repeats)."""
    rows = fill_col.shape[0]
    buf = fill_col[:, None].expand(rows, size + 1).clone()
    buf.index_copy_(1, dump_index(idx, size), src)
    return buf[:, :size]


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """31 - clz(x) for positive int32 x (floor(log2(x))), by binary search
    over shift widths: integer ops only."""
    x = x.to(I32)
    m = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        m = m + big.to(I32) * s
        x = torch.where(big, x >> s, x)
    return m


def _lex_lt_eq(h, q, or_equal: bool = False):
    """Lexicographic h < q (or <=) over leading-axis word rows (at least
    one), decided at the first differing word: a fixed handful of ops at
    any width, where the JAX package's word loop takes 4 a word (the
    simulator's fuzzers write keys of up to 10,000 bytes, 2,501 words)."""
    ne = h != q
    eq = ~ne.any(0)
    first = ne.to(torch.uint8).argmax(0, keepdim=True)
    lt = torch.gather(h < q, 0, first)[0]
    if or_equal:
        lt = lt | eq
    return lt, eq


def _lower_rank(hkeys, qmat):
    """#entries of the sorted (C, +inf padded) key matrix strictly less than
    each query key: log C halving steps, one 2-D column gather each (the
    largest result is C - 1, as tpu.py's walk gives)."""
    c = hkeys.shape[1]
    pos = torch.zeros(qmat.shape[1], dtype=I32, device=qmat.device)
    s = c // 2
    while s >= 1:
        h = hkeys[:, pos + (s - 1)]
        lt, _ = _lex_lt_eq(h, qmat)
        pos = pos + lt.to(I32) * s
        s //= 2
    return pos


def _build_table(v, op, identity: int):
    """(L, C) sparse range-query table: row m combines windows [i, i+2^m)."""
    c = v.shape[0]
    rows = [v]
    s = 1
    while s < c:
        prev = rows[-1]
        shifted = torch.cat(
            [prev[s:], torch.full((s,), identity, dtype=v.dtype, device=v.device)]
        )
        rows.append(op(prev, shifted))
        s *= 2
    return torch.stack(rows)


def _table_range_query(table, lo, hi, op, identity: int):
    """op-combine over [lo, hi) per query; empty ranges -> identity. Two
    gathers of overlapping power-of-two windows."""
    c = table.shape[1]
    length = (hi - lo).to(I32)
    m = floor_log2(torch.clamp(length, min=1))  # 31 - clz (hazard: no clz)
    window = torch.ones_like(m) << m
    flat = table.reshape(-1)
    base = m.to(torch.int64) * c
    got1 = flat[base + torch.clamp(lo, 0, c - 1)]
    got2 = flat[base + torch.clamp(hi - window, 0, c - 1)]
    return torch.where(hi > lo, op(got1, got2), identity)


def _canonical_nodes_flat(pos_lo, pos_hi, n_leaves: int):
    """Canonical segment-tree node ids of each [pos_lo, pos_hi) interval,
    flattened to 1-D (2*steps blocks of N), 0 marking unused slots (node 0
    is never a real node — root is 1). Pure integer arithmetic."""
    steps = n_leaves.bit_length()
    l = (pos_lo + n_leaves).to(I32)
    r = (pos_hi + n_leaves).to(I32)
    cols = []
    for _ in range(steps):
        active = l < r
        tl = active & ((l & 1) == 1)
        cols.append(torch.where(tl, l, 0))
        l = l + tl.to(I32)
        tr = active & ((r & 1) == 1)
        r = r - tr.to(I32)
        cols.append(torch.where(tr, r, 0))
        l = l >> 1
        r = r >> 1
    return torch.cat(cols), 2 * steps


def add_wrap_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 a + b with two's-complement wrap (computed in int64)."""
    s = a.to(I64) + b.to(I64)
    return (((s + 2**31) & 0xFFFFFFFF) - 2**31).to(I32)


def int8_twos(x: torch.Tensor) -> torch.Tensor:
    """Bytes 0..255 (int32) as int8 by two's complement, explicitly."""
    x = x.to(I32)
    return torch.where(x >= 128, x - 256, x).to(torch.int8)


def le_bytes(n: torch.Tensor) -> torch.Tensor:
    """The 4 little-endian bytes of a 0-d int32 tensor as int8 (st_aux's
    new_n field, tpu.py:914-916)."""
    shifts = torch.arange(0, 32, 8, dtype=I32, device=n.device)
    return int8_twos((n.to(I32) >> shifts) & 0xFF)


def _arange(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=dev)


def _pad_col(W: int, dev, with_value: bool = True) -> torch.Tensor:
    """One pad state column: +inf key words and length (and version 0),
    by device fills (a tensor made from host data would be a blocking
    copy)."""
    col = torch.full((W + 1,), I32_INF, dtype=I32, device=dev)
    if not with_value:
        return col
    return torch.cat([col, torch.zeros(1, dtype=I32, device=dev)])


def st_aux_ref(too_old, conflict, n_out, overflow, p2_iters):
    """The one verdict readback array: statuses ++ 4 LE bytes of n ++
    overflow ++ clamped phase-2 round count (tpu.py:909-920)."""
    statuses = torch.where(
        too_old, TOO_OLD, torch.where(conflict > 0, CONFLICT, COMMITTED)
    ).to(torch.int8)
    return torch.cat([
        statuses, le_bytes(n_out),
        overflow.to(torch.int8).reshape(1),
        int8_twos(torch.clamp(p2_iters, max=127)).reshape(1),
    ])
