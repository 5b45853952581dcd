"""Collective algorithm implementations over ``torch.distributed``.

The port of ``repro/collectives/algorithms.py``.  The NCCL algorithm /
protocol / channel space maps to:

  algorithm DEFAULT     -> the process group's own collective
                           (``dist.all_reduce``, ``reduce_scatter_tensor``,
                           ``all_gather_into_tensor``, ``all_to_all_single``):
                           NCCL's or gloo's built-in schedule
  algorithm RING        -> explicit reduce-scatter + all-gather rings of
                           point-to-point exchanges (n-1 + n-1 hops)
  algorithm BIDIR_RING  -> two counter-rotating rings, each carrying half
                           the channels
  algorithm TREE        -> recursive halving/doubling (2 log2 n hops),
                           latency-optimal for small messages; a ring for
                           a group size that is not a power of two
  protocol SIMPLE       -> full-precision wire
  protocol LL           -> bf16 wire, bf16 accumulation
  protocol LL128        -> bf16 wire, f32 accumulation
  n_channels            -> the tensor splits into ``c`` (at most 32)
                           independent chunk rings; each hop carries every
                           channel's chunk in one batch of exchanges

Every function takes ``(x, group, **kw)`` and returns a new tensor (the
``n == 1`` identity returns ``x`` itself, as the reference does).  The
reference's ``lax.ppermute`` is one ``dist.batch_isend_irecv`` per hop,
waited on before the next: each rank sends its block to ``rank + step``
and receives from ``rank - step``.  Ranks are group ranks; the exchange
maps them to global ranks.  The hop order, block placement, channel
chunking and padding are the reference's, so every algorithm adds the
same values in the same order on every rank.  Validated against the
group's own collective and the reference's outputs on an 8-rank gloo
group (``tests/test_torch_collectives.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.context import Proto

MAX_CHANNELS = 32


def wire_dtypes(protocol: int, dtype: torch.dtype
                ) -> Tuple[torch.dtype, torch.dtype]:
    """(wire_dtype, acc_dtype) for a protocol knob."""
    if protocol == Proto.SIMPLE or dtype == torch.bfloat16:
        return dtype, dtype
    if protocol == Proto.LL:
        return torch.bfloat16, torch.bfloat16
    if protocol == Proto.LL128:
        return torch.bfloat16, torch.float32
    return dtype, dtype


def _size_rank(group) -> Tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def _global(group, r: int) -> int:
    if group is None or group is dist.group.WORLD:
        return r
    return dist.get_global_rank(group, r)


def _exchange(group, pairs: List[Tuple[torch.Tensor, int, int]]
              ) -> List[torch.Tensor]:
    """One hop: for each ``(tensor, send_to, recv_from)`` send the tensor
    to group rank ``send_to`` and receive one of its shape from
    ``recv_from``; all of the hop's exchanges go out as one batch."""
    ops, outs = [], []
    for t, to, frm in pairs:
        t = t.contiguous()
        buf = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, _global(group, to), group))
        ops.append(dist.P2POp(dist.irecv, buf, _global(group, frm), group))
        outs.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


# ---------------------------------------------------------------------------
# native (DEFAULT)
# ---------------------------------------------------------------------------

def allreduce_native(x: torch.Tensor, group=None, **_) -> torch.Tensor:
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


def reduce_scatter_native(x: torch.Tensor, group=None, **_) -> torch.Tensor:
    n = dist.get_world_size(group)
    _check_leading(x, n)
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def all_gather_native(x: torch.Tensor, group=None, **_) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    # all_gather_into_tensor: its successor all_gather_single is missing
    # from some of the torch releases the port supports
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def all_to_all_native(x: torch.Tensor, group=None, *, split_axis: int = 0,
                      concat_axis: int = 0, tiled: bool = True, **_
                      ) -> torch.Tensor:
    """Tiled all-to-all over the leading dim: slot ``j`` goes to rank
    ``j``, the result holds the slots received in rank order."""
    if (split_axis, concat_axis, tiled) != (0, 0, True):
        raise ValueError("all_to_all supports split_axis=0, concat_axis=0, "
                         "tiled=True only")
    n = dist.get_world_size(group)
    _check_leading(x, n)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _check_leading(x: torch.Tensor, n: int) -> None:
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} must divide the group "
                         f"size {n}")


# ---------------------------------------------------------------------------
# ring
# ---------------------------------------------------------------------------

def _ring_allreduce(chunks: torch.Tensor, group, n: int, i: int, wire,
                    acc, n_fwd: int) -> torch.Tensor:
    """AllReduce ``c`` independent 1-D chunks (``chunks`` is ``(c, L)``,
    ``L % n == 0``) via RS+AG rings: chunks ``[:n_fwd]`` rotate forward
    (``rank -> rank + 1``), the rest backward.  Per chunk this is the
    reference's ``_ring_chunk_allreduce``."""
    c = chunks.shape[0]
    blocks = chunks.reshape(c, n, -1).to(acc)
    dirs = [(slice(0, n_fwd), 1), (slice(n_fwd, c), -1)]
    dirs = [(sl, st) for sl, st in dirs if sl.stop > sl.start]

    def hop(curs):
        return _exchange(group, [(cur.to(wire), (i + st) % n, (i - st) % n)
                                 for cur, (_, st) in zip(curs, dirs)])

    # reduce-scatter: at hop k a rank receives the partial sum of block
    # (i - k*step) and adds its local copy; after n-1 hops it owns the
    # fully reduced block (i + step) % n
    curs = [blocks[sl, i % n] for sl, _ in dirs]
    for k in range(1, n):
        sent = hop(curs)
        curs = [blocks[sl, (i - k * st) % n] + s.to(acc)
                for (sl, st), s in zip(dirs, sent)]
    # all-gather ring: the block received at hop k was owned by rank
    # (i - k*step)
    out = torch.zeros_like(blocks)
    for (sl, st), cur in zip(dirs, curs):
        out[sl, (i + st) % n] = cur
    for k in range(1, n):
        curs = [r.to(acc) for r in hop(curs)]
        for (sl, st), cur in zip(dirs, curs):
            out[sl, (i - k * st + st) % n] = cur
    return out.reshape(c, -1)


def _chunked(flat: torch.Tensor, n_channels: int, n: int
             ) -> Tuple[torch.Tensor, int]:
    """Split into n_channels independent chunks, each n-divisible."""
    c = max(1, min(n_channels, MAX_CHANNELS))
    quantum = n * c
    pad = (-flat.numel()) % quantum
    flat = F.pad(flat, (0, pad))
    return flat.reshape(c, -1), pad


def _ring_channels(x: torch.Tensor, group, n_chunks: int, bidir: bool,
                   protocol: int) -> torch.Tensor:
    n, i = _size_rank(group)
    if n == 1:
        return x
    wire, acc = wire_dtypes(protocol, x.dtype)
    flat = x.reshape(-1)
    chunks, pad = _chunked(flat, n_chunks, n)
    n_fwd = chunks.shape[0] // 2 if bidir else chunks.shape[0]
    out = _ring_allreduce(chunks, group, n, i, wire, acc, n_fwd)
    out = out.reshape(-1)
    if pad:
        out = out[:flat.numel()]
    return out.reshape(x.shape).to(x.dtype)


def allreduce_ring(x: torch.Tensor, group=None, *, n_channels: int = 1,
                   protocol: int = Proto.SIMPLE, **_) -> torch.Tensor:
    return _ring_channels(x, group, n_channels, False, protocol)


def allreduce_bidir_ring(x: torch.Tensor, group=None, *, n_channels: int = 1,
                         protocol: int = Proto.SIMPLE, **_) -> torch.Tensor:
    """Two counter-rotating rings, each carrying half the chunks."""
    c = max(1, min(n_channels, MAX_CHANNELS))
    return _ring_channels(x, group, 2 * c, True, protocol)


# ---------------------------------------------------------------------------
# tree (recursive halving-doubling)
# ---------------------------------------------------------------------------

def allreduce_tree(x: torch.Tensor, group=None, *, n_channels: int = 1,
                   protocol: int = Proto.SIMPLE, **_) -> torch.Tensor:
    n, i = _size_rank(group)
    if n == 1:
        return x
    if n & (n - 1):
        # a group size that is not a power of two: ring (NCCL does similar)
        return allreduce_ring(x, group, n_channels=n_channels,
                              protocol=protocol)
    wire, acc = wire_dtypes(protocol, x.dtype)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    cur = F.pad(flat, (0, pad)).to(acc)
    # halving reduce-scatter: distances n/2 ... 1
    d = n // 2
    while d >= 1:
        bit = (i & d) != 0
        lo, hi = cur.chunk(2)
        keep, send = (hi, lo) if bit else (lo, hi)
        (recv,) = _exchange(group, [(send.to(wire), i ^ d, i ^ d)])
        cur = keep + recv.to(keep.dtype)
        d //= 2
    # doubling all-gather: distances 1 ... n/2
    d = 1
    while d < n:
        bit = (i & d) != 0
        (recv,) = _exchange(group, [(cur.to(wire), i ^ d, i ^ d)])
        recv = recv.to(cur.dtype)
        cur = torch.cat([recv, cur] if bit else [cur, recv])
        d *= 2
    if pad:
        cur = cur[:x.numel()]
    return cur.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# reduce-scatter / all-gather (FSDP building blocks)
# ---------------------------------------------------------------------------

def reduce_scatter_ring(x: torch.Tensor, group=None, *,
                        protocol: int = Proto.SIMPLE, **_) -> torch.Tensor:
    """Ring reduce-scatter along the leading dim; returns this rank's
    ``x.shape[0] // n`` shard."""
    n, i = _size_rank(group)
    if n == 1:
        return x
    _check_leading(x, n)
    wire, acc = wire_dtypes(protocol, x.dtype)
    blocks = x.reshape(n, x.shape[0] // n, *x.shape[1:]).to(acc)
    cur = blocks[i]
    for k in range(1, n):
        (sent,) = _exchange(group, [(cur.to(wire), (i + 1) % n,
                                     (i - 1) % n)])
        cur = blocks[(i - k) % n] + sent.to(acc)
    # rank i owns block (i+1)%n; rotate so rank i owns block i
    (cur,) = _exchange(group, [(cur.to(wire), (i + 1) % n, (i - 1) % n)])
    return cur.to(acc).to(x.dtype)


def all_gather_ring(x: torch.Tensor, group=None, *,
                    protocol: int = Proto.SIMPLE, **_) -> torch.Tensor:
    n, i = _size_rank(group)
    if n == 1:
        return x
    wire, _ = wire_dtypes(protocol, x.dtype)
    out = x.new_zeros((n,) + tuple(x.shape))
    out[i] = x
    cur = x
    for k in range(1, n):
        (cur,) = _exchange(group, [(cur.to(wire), (i + 1) % n, (i - 1) % n)])
        cur = cur.to(x.dtype)
        out[(i - k) % n] = cur
    return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))


# ---------------------------------------------------------------------------
# all-to-all (MoE dispatch path)
# ---------------------------------------------------------------------------

def all_to_all_chunked(x: torch.Tensor, group=None, *, n_channels: int = 1,
                       protocol: int = Proto.SIMPLE, **_) -> torch.Tensor:
    """Point-to-point all-to-all over the leading dim (tiled semantics):
    ``x.shape[0]`` splits into n slots; slot j goes to rank j.  Hop k
    sends slot ``(i + k) % n`` and receives from rank ``(i - k) % n``."""
    n, i = _size_rank(group)
    if n == 1:
        return x
    _check_leading(x, n)
    wire, _ = wire_dtypes(protocol, x.dtype)
    blocks = x.reshape(n, x.shape[0] // n, *x.shape[1:])
    out = torch.zeros_like(blocks)
    out[i] = blocks[i]
    for k in range(1, n):
        (recv,) = _exchange(group, [(blocks[(i + k) % n].to(wire),
                                     (i + k) % n, (i - k) % n)])
        out[(i - k) % n] = recv.to(x.dtype)
    return out.reshape(x.shape)


__all__ = ["wire_dtypes", "allreduce_native", "reduce_scatter_native",
           "all_gather_native", "all_to_all_native", "allreduce_ring",
           "allreduce_bidir_ring", "allreduce_tree", "reduce_scatter_ring",
           "all_gather_ring", "all_to_all_chunked"]
