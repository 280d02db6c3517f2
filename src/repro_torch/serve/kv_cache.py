"""Paged KV cache for the serving engine (counterpart of
``repro.serve.kv_cache``).

The dense cache the port's attention consumes is, per layer, ``k`` and
``v`` of ``(B, shards, span, KV, HD)`` (``Attention.cache_spec``): token
``t`` lives at ``(shard t//span, slot t%span)``. Paging keeps the same
layout but chops the span into fixed ``bspan``-slot blocks held in a shared
pool:

    pool leaf: (num_blocks, shards, bspan, KV, HD), one per layer and per
               k and v

The reference stacks its layers and so its pool leaves; the port's cache is
a list of per-layer dicts (``{"blocks": [{"k", "v"}, ...]}``), and so is its
pool. Block ``j`` of a sequence covers slots ``[j·bspan, (j+1)·bspan)`` in
every shard, ``block_tokens = shards·bspan`` tokens, so a sequence of ``L``
tokens owns ``ceil(min(L, span)/bspan)`` blocks and the rest of the pool is
free for other sequences.

The pool's leaves record the dense cache's logical axes with the blocks
axis replicated (``POOL_AXES``), so ``serve_tp`` and ``serve_seqkv`` split
the pool as they split the dense cache: across ranks each leaf is a
``parallel.sharded.Sharded`` whose local block is this rank's kv heads
(serve_tp) or its shards (serve_seqkv) of every block, and the block
tables are the same on every rank. ``gather_view`` (an index over the
blocks axis and a reshape) builds, from the local blocks, this rank's
block of the dense view that ``Attention.decode`` consumes unchanged, a
copy; ``scatter_blocks`` writes the touched blocks of that view back into
the local pool, in place. On a mesh with a data axis the blocks axis stays
replicated, as the reference's ``pool_spec`` keeps it, so every data group
holds the whole pool; a decode batch split over "data" gathers and
scatters only this rank's rows (``gather_view``'s ``rows``), so a group
writes the blocks of its own rows and reads only those (a prompt chunk,
one row, is written by every group). Exactness against the dense path is
gated by ``max_abs_diff``.

Allocation is host-side and O(1): a free-list ``BlockAllocator`` with
block 0 reserved as the null block. Unallocated block-table entries point
at it, and writes landing there (engine rows that are not decoding) are
never read back as valid positions: the attention's valid mask (key
position ≤ query position) covers them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..nn.attention import CACHE_AXES
from ..parallel.sharded import Sharded, block_index

NULL_BLOCK = 0
# a pool leaf's logical axes: the dense cache's, its batch dim the blocks
POOL_AXES = (None,) + CACHE_AXES[1:]


# ---------------------------------------------------------------------------
# Host-side free-list allocator
# ---------------------------------------------------------------------------
class BlockAllocator:
    """Fixed pool of ``num_blocks`` blocks; block 0 is the reserved null
    block and is never handed out. ``alloc`` returns None when the pool
    cannot cover the request (the engine's admission control backs off
    instead of failing)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        self.num_blocks = num_blocks
        # pop() from the end hands out ascending ids first: deterministic
        # layouts for tests and reproducible traces
        self._free = list(range(num_blocks - 1, 0, -1))

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> "list[int] | None":
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, ids) -> None:
        for i in ids:
            i = int(i)
            if not 0 < i < self.num_blocks:
                raise ValueError(f"block id {i} out of range")
            if i in self._free:
                raise ValueError(f"double free of block {i}")
            self._free.append(i)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CacheGeometry:
    """Shared shape facts of every attention cache leaf in the model."""

    shards: int        # cache shard dim (1 | the model axis's size)
    span: int          # slots per shard (max_len // shards)
    bspan: int         # slots per shard per block
    n_blk: int         # blocks per sequence (span // bspan)
    kv_bytes_per_token: int  # summed over layers, at the cache's dtype

    @property
    def block_tokens(self) -> int:
        """Allocation granularity in tokens."""
        return self.shards * self.bspan

    @property
    def max_len(self) -> int:
        return self.shards * self.span

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks a sequence of ``n_tokens`` (prompt + gen) occupies."""
        used = min(max(n_tokens, 1), self.span)
        return -(-used // self.bspan)


def _leaves(tree: dict):
    """(layer, name, leaf) of a cache or pool tree, in layer order."""
    for i, layer in enumerate(tree["blocks"]):
        for name, leaf in layer.items():
            yield i, name, leaf


def _leaf_dims(name: str, t: torch.Tensor):
    """(shards, span, tail) of one dense cache leaf; raises for the
    non-attention caches (an SSM's state and conv tails)."""
    if name not in ("k", "v") or t.dim() != 5:
        raise ValueError(
            f"unsupported cache leaf {name!r} {tuple(t.shape)}: the paged "
            f"pool serves attention caches (B, shards, span, KV, HD) only")
    return t.shape[1], t.shape[2], tuple(t.shape[3:])


def cache_geometry(model, max_len: int, *, shards: int = 1,
                   block_tokens: int = 16,
                   dtype: torch.dtype = torch.bfloat16) -> CacheGeometry:
    """Validate the model's cache for paging and derive the geometry.

    Every leaf must share (shards, span); non-attention caches are rejected
    here, the one reason the serving engine takes attention-only models.
    A ``shards`` that does not divide ``max_len`` leaves every layer one
    shard (``Block.cache_spec``), which the coverage check then names.
    """
    spec = model.cache_spec(1, max_len, shards=shards, dtype=dtype)
    geo = None
    kv_bytes = 0
    for _, name, t in _leaves(spec):
        sh, span, tail = _leaf_dims(name, t)
        if geo is None:
            geo = (sh, span)
        elif geo != (sh, span):
            raise ValueError(
                f"non-uniform cache geometry {geo} vs {(sh, span)}: paged "
                "serving needs every layer's cache to share (shards, span)")
        kv_bytes += sh * span * int(np.prod(tail)) * t.element_size()
    if geo is None:
        raise ValueError("model has an empty cache spec")
    sh, span = geo
    if sh * span != max_len:
        raise ValueError(f"cache covers {sh * span} slots, want {max_len}")
    if block_tokens % sh:
        raise ValueError(f"block_tokens={block_tokens} must be a multiple "
                         f"of kv_shards={sh}")
    bspan = block_tokens // sh
    if span % bspan:
        raise ValueError(f"block span {bspan} must divide the cache span "
                         f"{span} (max_len/kv_shards)")
    return CacheGeometry(shards=sh, span=span, bspan=bspan,
                         n_blk=span // bspan,
                         kv_bytes_per_token=kv_bytes // max_len)


# ---------------------------------------------------------------------------
# Pool spec + gather/scatter views
# ---------------------------------------------------------------------------
def pool_spec(model, geo: CacheGeometry, num_blocks: int,
              dtype: torch.dtype = torch.bfloat16) -> dict:
    """The shared block pool as meta tensors, in the cache's tree, each leaf
    recording ``POOL_AXES`` (``nn.module.zeros_like_spec`` makes it, each
    rank's blocks across ranks)."""
    spec = model.cache_spec(1, geo.max_len, shards=geo.shards, dtype=dtype)
    blocks = [{} for _ in spec["blocks"]]
    for i, name, t in _leaves(spec):
        sh, _, tail = _leaf_dims(name, t)
        leaf = torch.empty((num_blocks, sh, geo.bspan) + tail,
                           dtype=t.dtype, device="meta")
        leaf.axes = POOL_AXES
        blocks[i][name] = leaf
    return {"blocks": blocks}


def _local(t):
    return t.local if isinstance(t, Sharded) else t


def gather_view(pool: dict, tables: torch.Tensor, rows: tuple = ()) -> dict:
    """Dense cache of the sequences in ``tables`` (B, n_blk) block ids: an
    index over the pool's blocks axis and a reshape, a new tensor per leaf
    (of a ``Sharded`` pool leaf, this rank's block of the dense view, a
    ``Sharded`` placed as the leaf, its batch dim split over ``rows``, the
    mesh axes the rules give a batch of B: this rank gathers only its block
    of the rows). Null-block entries materialise garbage at positions the
    attention's valid mask (key position ≤ query position) never
    exposes."""
    def one(leaf):
        mine = tables
        if rows:
            mine = tables[block_index(leaf.mesh, tables.shape[:1],
                                      (rows,))[0]]
        g = _local(leaf)[mine]                # (b, nblk, sh, bspan, KV, HD)
        b, nblk, sh, bspan = g.shape[:4]
        view = g.transpose(1, 2).reshape(b, sh, nblk * bspan, *g.shape[4:])
        if not isinstance(leaf, Sharded):
            return view
        shape = (tables.shape[0], leaf.shape[1], nblk * bspan) \
            + leaf.shape[3:]
        return Sharded(view, shape, (rows,) + leaf.place[1:], leaf.mesh)

    return {"blocks": [{name: one(leaf) for name, leaf in layer.items()}
                       for layer in pool["blocks"]]}


def scatter_blocks(pool: dict, tables: torch.Tensor, dense: dict,
                   jidx: torch.Tensor) -> dict:
    """Write blocks ``jidx`` (B, nj) of the dense view back into the pool,
    in place (the local blocks of both, across ranks; of a view whose rows
    are split, this rank's rows only); returns the pool.

    A decode step touches one block per sequence, a prefill chunk a fixed
    range, so a step writes O(touched blocks), not O(max_len). Rows parked
    on the null block (engine rows not decoding) all write block 0: on CUDA
    several writes to one place land in no set order, so block 0's contents
    are not deterministic, and no valid position ever reads them.
    """
    first = dense["blocks"][0][next(iter(dense["blocks"][0]))]
    if isinstance(first, Sharded) and first.place[0]:
        mine = block_index(first.mesh, first.shape, first.place)[0]
        tables, jidx = tables[mine], jidx[mine]
    ids = torch.take_along_dim(tables, jidx, dim=1).reshape(-1)   # (B·nj,)
    nblk = tables.shape[1]
    rows = torch.arange(jidx.shape[0], device=jidx.device)[:, None]
    for i, name, leaf in _leaves(pool):
        dl = _local(dense["blocks"][i][name])
        B, sh, span = dl.shape[:3]
        blocks = dl.reshape(B, sh, nblk, span // nblk, *dl.shape[3:]
                            ).transpose(1, 2)         # (B, nblk, sh, bspan, .)
        sel = blocks[rows, jidx]                      # (B, nj, sh, bspan, .)
        leaf = _local(leaf)
        leaf[ids] = sel.reshape(-1, *sel.shape[2:]).to(leaf.dtype)
    return pool


def max_abs_diff(pool: dict, tables: torch.Tensor, dense: dict,
                 geo: CacheGeometry, length: int) -> float:
    """Exactness gate: largest |paged − dense| over the first ``length``
    token positions of the sequences in ``tables`` against a dense
    reference cache (across ranks this rank's blocks of both, the dense
    cache placed as the pool). 0.0 ⇔ bit-exact (the same dtype on both
    sides)."""
    view = gather_view(pool, tables)
    worst = 0.0
    for i, name, a in _leaves(view):
        b = _local(dense["blocks"][i][name])
        first = 0
        if isinstance(a, Sharded):
            first = block_index(a.mesh, a.shape, a.place)[1].start
            a = a.local
        slot = torch.arange(geo.max_len).reshape(geo.shards, geo.span)[
            first:first + a.shape[1]]
        mask = (slot < length)[:, :, None, None]      # (shards, span, 1, 1)
        d = (a.float() - b.float()).abs().cpu() * mask
        worst = max(worst, float(d.max()))
    return worst
