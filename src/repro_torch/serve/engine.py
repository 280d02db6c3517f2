"""Continuous batching over a paged KV cache (counterpart of
``repro.serve.engine``).

One ``Engine`` owns a shared block pool (``serve/kv_cache.py``), a FIFO
request queue with admission control, and two cells:

  * ``_prefill``: one ``prefill_chunk``-token chunk of ONE sequence per
    engine step, so a long prompt prefills across several steps,
    interleaved with decode, and a new arrival never stalls the decodes in
    flight for its whole prompt;
  * ``_decode``: one token for EVERY live sequence at once. Sequences join
    and leave the shared batch per step (continuous batching), each at its
    own depth through the per-sequence ``pos`` vector ``Attention.decode``
    takes.

Both cells gather the paged pool into the dense view the attention path
consumes, run ``model.decode_step`` on it, and scatter back only the
touched blocks. The reference jits the cells and donates the pool so XLA
updates it in place; here the pool's tensors are written in place.

Across ranks (a sharded ``ctx``, a (p1, p2) mesh of "data" and "model")
one ``Engine`` runs on every rank over the same model's blocks: the pool
is each rank's block of the reference's (``kv_cache.pool_spec``), split as
the ctx's rules split the dense cache, serve_tp on its kv heads,
serve_seqkv on its shards (``kv_shards`` = p2), its blocks axis replicated
over "data" as the reference's. A prompt chunk (one row) is computed by
every data group, as the reference's replicated prefill is; a decode
batch's ``max_batch`` rows are split in blocks over "data" (``max_batch``
must divide by p1), each group runs its rows over its "model" ranks,
serve_tp and serve_seqkv as on a (1, p2) mesh, and ``greedy`` gathers the
groups' tokens over "data". The reference is one controller; here every
rank runs the host schedule, which must be the same on every rank or the
ranks' collectives deadlock. It is: admission, block tables and batch
rows follow from the requests and the tokens, which every rank holds
whole (``models.transformer.greedy``, a distributed argmax over the vocab
split: 2 numbers a row cross the ranks, not the logits), and an open-loop
replay admits against rank 0's clock, broadcast once a step. The report's
times are each rank's own; callers read rank 0's.

Positions stay in range. ``Attention.decode`` writes the cache by indexing,
so a position past ``max_len`` is an error (on the card a device-side
assert), where the reference's one-hot write drops it. So, as in the
reference, a request is admitted only if its chunk-padded prompt and its
generation fit in ``max_len``, and rows that are not decoding in a decode
step get position 0 and the null block.

Device syncs: the host reads the next token after a prompt's last chunk
and after each decode batch, and nowhere else; the step's small host
arrays reach the card by pinned, non-blocking copies.

Batch membership does not change the math: every per-token op (embedding,
norms, FFN, each row's attention against its own cache view) touches one
batch row, so in fp32 a sequence decoded among others emits the tokens it
emits alone (tests/test_torch_serve_engine.py).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..models.transformer import greedy
from ..nn.module import ShardingCtx, zeros_like_spec
from ..parallel import collectives as coll
from ..parallel.sharded import placement
from . import kv_cache as kvc

__all__ = ["ServeConfig", "Request", "RequestStats", "ServeReport",
           "Engine"]


@dataclass(frozen=True)
class ServeConfig:
    """Engine shape knobs."""

    max_len: int                 # per-sequence capacity (prompt + gen)
    max_batch: int = 4           # decode slots (continuous-batch width)
    block_tokens: int = 16       # paged-cache allocation granularity
    num_blocks: int | None = None  # pool size; None → every slot can fill
    prefill_chunk: int = 32      # prompt tokens prefilled per engine step
    kv_shards: int = 1           # cache span shards (1 | mesh model size)
    dtype: torch.dtype | None = None   # cache dtype; None → bfloat16


@dataclass(frozen=True)
class Request:
    rid: int
    prompt: np.ndarray           # (L,) int32 token ids
    max_new: int
    arrival: float = 0.0         # trace time (seconds from replay start)


@dataclass
class RequestStats:
    rid: int
    arrival: float
    prompt_len: int
    max_new: int
    admitted: float = 0.0
    first_token: float = 0.0     # engine-clock time of token 1 (TTFT ref)
    finished: float = 0.0
    tokens: list = field(default_factory=list)

    @property
    def ttft(self) -> float:
        return self.first_token - self.arrival

    @property
    def latency(self) -> float:
        return self.finished - self.arrival


@dataclass
class ServeReport:
    requests: list
    wall_s: float

    @property
    def n_tokens(self) -> int:
        return sum(len(r.tokens) for r in self.requests)

    @property
    def tok_per_s(self) -> float:
        return self.n_tokens / max(self.wall_s, 1e-9)

    def percentile(self, q: float, what: str = "latency") -> float:
        vals = [getattr(r, what) for r in self.requests]
        return float(np.percentile(vals, q)) if vals else 0.0

    def summary(self) -> dict:
        return {
            "requests": len(self.requests),
            "tokens": self.n_tokens,
            "wall_s": self.wall_s,
            "tok_per_s": self.tok_per_s,
            "ttft_p50_s": self.percentile(50, "ttft"),
            "ttft_p99_s": self.percentile(99, "ttft"),
            "latency_p50_s": self.percentile(50),
            "latency_p99_s": self.percentile(99),
        }


class _Seq:
    """One live sequence: its slot, block ownership and progress."""

    __slots__ = ("req", "stats", "blocks", "prompt_pad", "cursor", "pos",
                 "last_token", "phase")

    def __init__(self, req, stats, blocks, prompt_pad):
        self.req = req
        self.stats = stats
        self.blocks = blocks
        self.prompt_pad = prompt_pad   # (Lp_pad,) chunk-padded prompt
        self.cursor = 0                # prefill progress (tokens)
        self.pos = 0                   # next write position
        self.last_token = 0
        self.phase = "prefill"


class Engine:
    """Continuous-batching engine over one (model × ctx) cell; the model's
    own parameters are the weights."""

    def __init__(self, model, ctx: ShardingCtx, cfg: ServeConfig):
        if not (hasattr(model, "decode_step") and hasattr(model, "prefill")):
            raise ValueError(f"{type(model).__name__} has no decode path")
        serving_mesh(ctx, cfg.max_batch)
        dtype = cfg.dtype or torch.bfloat16
        self.model, self.ctx, self.cfg = model, ctx, cfg
        geo = kvc.cache_geometry(model, cfg.max_len, shards=cfg.kv_shards,
                                 block_tokens=cfg.block_tokens, dtype=dtype)
        C = cfg.prefill_chunk
        if C % geo.bspan or geo.span % C:
            raise ValueError(
                f"prefill_chunk={C} must be a multiple of the block span "
                f"{geo.bspan} and divide the cache span {geo.span}")
        self.geo = geo
        num_blocks = cfg.num_blocks or cfg.max_batch * geo.n_blk + 1
        self.alloc = kvc.BlockAllocator(num_blocks)
        self.pool = zeros_like_spec(kvc.pool_spec(model, geo, num_blocks,
                                                  dtype), ctx.device, ctx)
        # the mesh axes that split a decode batch's rows (the rules' "batch")
        self._rows = placement(ctx.mesh, ctx.pspec(
            ("batch",), (cfg.max_batch,)))[0] if ctx.sharded else ()
        self.tables = np.full((cfg.max_batch, geo.n_blk), kvc.NULL_BLOCK,
                              np.int64)
        self.slots: list = [None] * cfg.max_batch
        self.queue: deque = deque()
        self.finished: list = []
        self._t0 = time.perf_counter()

    # -- the two cells -----------------------------------------------------
    def _device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without a device sync: on
        the card a non-blocking copy from pinned memory (the caching host
        allocator keeps the pinned block until the copy has run)."""
        t = torch.from_numpy(a)
        if self.ctx.device.type == "cuda":
            return t.pin_memory().to(self.ctx.device, non_blocking=True)
        return t

    @torch.no_grad()
    def _prefill(self, tokens, table_row, p0: int) -> torch.Tensor:
        """One chunk (1, C) of one sequence at positions p0 .. p0+C−1;
        returns its logits (1, C, vocab)."""
        geo, C = self.geo, self.cfg.prefill_chunk
        tables = self._device(table_row)
        dense = kvc.gather_view(self.pool, tables)
        logits, dense = self.model.decode_step(
            self._device(tokens), dense, self._device(np.array([p0])),
            self.ctx)
        j0 = (p0 % geo.span) // geo.bspan
        jidx = np.arange(j0, j0 + C // geo.bspan)[None]
        kvc.scatter_blocks(self.pool, tables, dense, self._device(jidx))
        return logits

    @torch.no_grad()
    def _decode(self, tokens, tables, pos) -> torch.Tensor:
        """One token (B, 1) for every row at its ``pos``; returns the
        greedy next tokens (B,) on the device."""
        geo = self.geo
        tables_d = self._device(tables)
        dense = kvc.gather_view(self.pool, tables_d, self._rows)
        logits, dense = self.model.decode_step(
            self._device(tokens), dense, self._device(pos), self.ctx)
        jidx = ((pos % geo.span) // geo.bspan)[:, None]
        kvc.scatter_blocks(self.pool, tables_d, dense, self._device(jidx))
        return greedy(logits)[:, -1]

    def _first_token(self, stats: RequestStats, logits, last: int) -> int:
        """The greedy token from a prompt chunk's logits (1, C, vocab) at
        its position ``last``, the prompt's last: a device sync."""
        return int(greedy(logits)[0, last])

    def reset(self) -> None:
        """Forget every request: a fresh replay on the same pool
        (measurement warm-up). The pool's contents become garbage until
        rewritten, which the attention's valid mask never exposes."""
        self.alloc = kvc.BlockAllocator(self.alloc.num_blocks)
        self.tables[:] = kvc.NULL_BLOCK
        self.slots = [None] * self.cfg.max_batch
        self.queue.clear()
        self.finished = []
        self._t0 = time.perf_counter()

    # -- bookkeeping -------------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _clock(self) -> float:
        """The engine clock every rank admits against: rank 0's, broadcast
        (this rank's own on one device)."""
        if not self.ctx.sharded:
            return self._now()
        mesh = self.ctx.mesh
        t = torch.tensor([self._now()], dtype=torch.float64,
                         device=mesh.host_device)
        return float(coll.broadcast_(t, mesh.group(mesh.axes)))

    @property
    def n_live(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def idle(self) -> bool:
        return not self.queue and self.n_live == 0

    def submit(self, req: Request) -> None:
        Lp = len(req.prompt)
        if Lp < 1 or req.max_new < 1:
            raise ValueError("empty prompt / zero generation")
        C = self.cfg.prefill_chunk
        lp_pad = -(-Lp // C) * C
        if lp_pad + req.max_new > self.cfg.max_len:
            raise ValueError(
                f"request {req.rid} needs {lp_pad}+{req.max_new} tokens "
                f"(prompt chunk-padded) > max_len={self.cfg.max_len}")
        if self.geo.blocks_for(lp_pad + req.max_new) > self.alloc.capacity:
            raise ValueError(
                f"request {req.rid} can never fit: needs "
                f"{self.geo.blocks_for(lp_pad + req.max_new)} blocks, pool "
                f"holds {self.alloc.capacity}")
        self.queue.append(req)

    def _try_admit(self) -> None:
        """FIFO admission: a request enters when a decode slot is free AND
        the pool can cover its whole footprint (prompt + generation), so
        admitted sequences never deadlock on blocks."""
        while self.queue:
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                return
            req = self.queue[0]
            C = self.cfg.prefill_chunk
            lp_pad = -(-len(req.prompt) // C) * C
            ids = self.alloc.alloc(self.geo.blocks_for(lp_pad + req.max_new))
            if ids is None:
                return                      # head-of-line waits for evicts
            self.queue.popleft()
            slot = free_slots[0]
            pad = np.zeros(lp_pad, np.int32)
            pad[:len(req.prompt)] = np.asarray(req.prompt, np.int32)
            stats = RequestStats(req.rid, req.arrival, len(req.prompt),
                                 req.max_new, admitted=self._now())
            self.slots[slot] = _Seq(req, stats, ids, pad)
            self.tables[slot] = kvc.NULL_BLOCK
            self.tables[slot, :len(ids)] = ids

    def _evict(self, slot: int) -> None:
        seq = self.slots[slot]
        seq.stats.finished = self._now()
        self.finished.append(seq.stats)
        self.alloc.free(seq.blocks)
        self.tables[slot] = kvc.NULL_BLOCK
        self.slots[slot] = None

    # -- the engine step ---------------------------------------------------
    def step(self) -> int:
        """One iteration: admit → one prefill chunk → one decode batch
        step. Returns the number of tokens emitted."""
        self._try_admit()
        emitted = 0

        # prefill: one chunk of the oldest prefilling sequence
        pf = next((i for i, s in enumerate(self.slots)
                   if s is not None and s.phase == "prefill"), None)
        if pf is not None:
            seq = self.slots[pf]
            C = self.cfg.prefill_chunk
            chunk = seq.prompt_pad[seq.cursor:seq.cursor + C]
            logits = self._prefill(chunk[None], self.tables[pf:pf + 1],
                                   seq.cursor)
            seq.cursor += C
            if seq.cursor >= len(seq.prompt_pad):
                last = seq.stats.prompt_len - 1 - (seq.cursor - C)
                tok = self._first_token(seq.stats, logits, last)
                seq.stats.tokens.append(tok)
                seq.stats.first_token = self._now()
                seq.last_token = tok
                seq.pos = seq.stats.prompt_len
                seq.phase = "decode"
                emitted += 1
                if len(seq.stats.tokens) >= seq.req.max_new:
                    self._evict(pf)

        # decode: one token for every live decoding sequence
        live = [i for i, s in enumerate(self.slots)
                if s is not None and s.phase == "decode"]
        if live:
            tokens = np.zeros((self.cfg.max_batch, 1), np.int32)
            pos = np.zeros(self.cfg.max_batch, np.int64)
            # rows not decoding this step (free, or mid-prefill) point at
            # the null block, so their placeholder write at position 0
            # cannot land in a real block (a mid-prefill row's first chunk
            # would otherwise be overwritten)
            dtab = np.full_like(self.tables, kvc.NULL_BLOCK)
            for i in live:
                tokens[i, 0] = self.slots[i].last_token
                pos[i] = self.slots[i].pos
                dtab[i] = self.tables[i]
            toks = self._decode(tokens, dtab, pos).cpu().numpy()
            for i in live:
                seq = self.slots[i]
                tok = int(toks[i])
                seq.stats.tokens.append(tok)
                seq.last_token = tok
                seq.pos += 1
                emitted += 1
                if len(seq.stats.tokens) >= seq.req.max_new:
                    self._evict(i)
        return emitted

    # -- trace replay ------------------------------------------------------
    def run(self, requests, *, honor_arrivals: bool = True) -> ServeReport:
        """Replay a trace to completion. With ``honor_arrivals`` a request
        becomes visible only once the engine clock passes its arrival time
        (open-loop load); without, everything is enqueued up front
        (closed-loop, maximum throughput)."""
        pending = deque(sorted(requests, key=lambda r: r.arrival))
        self._t0 = time.perf_counter()
        while pending or not self.idle:
            t = self._clock() if honor_arrivals else self._now()
            while pending and (not honor_arrivals
                               or pending[0].arrival <= t):
                req = pending.popleft()
                if not honor_arrivals:
                    # closed loop: latency counts from submission, not from
                    # the trace's (ignored) arrival stamps
                    req = replace(req, arrival=t)
                self.submit(req)
            if self.step() == 0 and self.n_live == 0 and not self.queue:
                if pending:
                    # nothing runnable yet: park until the next arrival
                    time.sleep(max(pending[0].arrival - self._now(), 0.0))
        wall = self._now()
        done = sorted(self.finished, key=lambda s: s.rid)
        return ServeReport(requests=done, wall_s=wall)


def serving_mesh(ctx: ShardingCtx, max_batch: int) -> None:
    """Raises for a mesh the engine does not serve on: any axis but "data"
    and "model" above 1 (the SUMMA grid trains; it serves nothing), or a
    decode batch of ``max_batch`` rows that the "data" axis cannot split
    into whole blocks."""
    if not ctx.sharded:
        return
    other = {a: n for a, n in ctx.mesh.shape.items()
             if a not in ("data", "model") and n > 1}
    if other:
        raise NotImplementedError(
            f"a serving mesh with {other}: the engine serves (data, model) "
            f"meshes")
    p1 = ctx.mesh.shape.get("data", 1)
    if max_batch % p1:
        raise ValueError(f"max_batch={max_batch} does not split over the "
                         f"{p1} data groups of the mesh")
