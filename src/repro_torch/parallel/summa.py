"""2-D (SUMMA-style) tensor parallelism over a (row × col) model grid
(counterpart of ``repro.parallel.summa``).

The 1-D model strategies (filter, channel, df) split ONE hidden dimension
per matmul and pay a full-width collective on the other. SUMMA [van de
Geijn & Watts '97; Xu et al., 2-D tensor parallelism in ColossalAI] block-
distributes every operand over an (r × c) grid instead, so the collectives
shrink to panels. For ``y = x @ w`` with x: (B, S, K) and w: (K, N):

  * x lives as (B, S/r, K/c) blocks, w as (K/r, N/c) blocks, y as
    (B, S/r, N/c) blocks: the residual stream is split two ways (seq over
    the grid rows, which is sequence parallelism built in; hidden over the
    grid columns);
  * forward: all-gather x's blocks along the grid COLUMNS (full K on every
    rank, c − 1 hops of the small activation block), then r ring steps
    along the grid ROWS: each contracts the matching K slice of the
    gathered x with the weight panel held at that step, accumulating in
    fp32, and passes the panel one hop on (``collectives.ring_shift``);
  * backward (``_Summa.backward``, the adjoint of each step): dx's
    partials over the whole K are reduce-scattered along the columns, and
    dW runs the ring reversed, each rank adding its part to the partial
    sum it receives before passing it back, so the panel's gradient ends
    on the rank that holds the panel. Gradients are exact up to the order
    of the fp32 sums.

The oracle prices this path as the "summa" row (``core/oracle.py``):
(c − 1) activation-panel hops and (r − 1) weight-panel hops per matmul.

Deployment: the "summa" rules table (``parallel/strategies.py``) puts seq
on ``model_r`` and every hidden axis on ``model_c``; ``summa_axes`` detects
that table on a grid mesh (``launch.mesh.make_grid_mesh``), and
``nn/ffn.py`` and ``nn/attention.py`` route their projections through
``summa_matmul`` where the matching ``_ok`` holds, falling back to the
rules table's own path (``nn.layers.project`` on the placements the table
gives) where a shape does not divide the grid, as the reference falls back
to GSPMD. The QKV bias, RoPE and the norms stay with the caller; the
embedding, the norms and the head run under the table's placements
(embed on model_r; vocab, act_embed and heads on model_c; seq on model_r).

The reference routes only attention and FFN projections: its CNNs and its
SSD under this table are GSPMD's placements, which the port does not
reproduce yet, so a CNN or an SSM model on the grid raises
(``summa_supported``, ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import math

import torch

from . import collectives as C
from .sharded import Sharded, param_block

ROW_AXIS = "model_r"   # seq of the activations, K of the weights: p2r ranks
COL_AXIS = "model_c"   # the hidden dims: p2c ranks
GRID_AXES = (ROW_AXIS, COL_AXIS)
GRID_ONLY = ("the 2-D grid runs the attention LMs only: SUMMA for the CNNs "
             "and the SSM LMs is ROADMAP queue 1 item 8")


def summa_axes(ctx) -> tuple[str, str] | None:
    """(row, col) mesh axis names when ``ctx`` deploys the 2-D grid, else
    None: a mesh of more than one rank carrying both grid axes and the
    "summa" rules table (the only table that puts the residual's seq on
    the grid rows and its embed on the grid columns)."""
    mesh = ctx.mesh
    if not ctx.sharded or ROW_AXIS not in mesh.shape or \
            COL_AXIS not in mesh.shape:
        return None
    if ctx.rules.get("seq") != ROW_AXIS or \
            ctx.rules.get("act_embed") != COL_AXIS:
        return None
    return GRID_AXES


def summa_supported(model_or_cfg) -> str | None:
    """None where the grid can run the model (an LM of attention blocks),
    else the reason."""
    from ..models.transformer import LMConfig
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    if not isinstance(cfg, LMConfig):
        return f"{type(cfg).__name__}: {GRID_ONLY}"
    if "ssm" in cfg.pattern:
        return f"{cfg.name} has SSM blocks: {GRID_ONLY}"
    return None


def grid_shape(mesh) -> tuple[int, int]:
    """(r, c) extents of the model grid."""
    return mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]


def _dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def matmul_ok(mesh, x_shape, k: int, n: int) -> bool:
    """True when ``summa_matmul``'s blocks divide (B, S, k) @ (k, n)
    exactly; callers fall back to the rules table's path otherwise."""
    r, c = grid_shape(mesh)
    dp = math.prod(mesh.shape[a] for a in _dp_axes(mesh))
    return (x_shape[0] % dp == 0 and x_shape[1] % r == 0
            and k % (r * c) == 0 and n % c == 0)


def _split(mesh, axis: str) -> tuple[str, ...]:
    """A dim's placement over one mesh axis (none where its extent is 1)."""
    return (axis,) if mesh.shape[axis] > 1 else ()


class _Summa(torch.autograd.Function):
    """The local SUMMA product of one rank's blocks: xl (B, S/r, K/c) and
    wl (K/r, N/c) → (B, S/r, N/c)."""

    @staticmethod
    def forward(ctx, xl, wl, rows, cols):
        xf = C.gather_blocks(xl, 2, cols) if cols.size > 1 else xl
        r, i = rows.size, rows.index
        kr = xf.shape[2] // r
        acc = torch.zeros(xl.shape[:2] + (wl.shape[1],), dtype=torch.float32,
                          device=xl.device)
        panels, panel = [], wl
        for t in range(r):
            # after t hops row i holds the panel of row (i − t) mod r
            src = (i - t) % r
            acc = acc + xf[..., src * kr:(src + 1) * kr].float() @ \
                panel.float()
            panels.append(panel)
            if t + 1 < r:
                panel = C.ring_shift(panel, rows)
        ctx.save_for_backward(xf, *panels)
        ctx.rows, ctx.cols, ctx.w_dtype = rows, cols, wl.dtype
        return acc.to(xl.dtype)

    @staticmethod
    def backward(ctx, gy):
        xf, *panels = ctx.saved_tensors
        rows, cols = ctx.rows, ctx.cols
        r, i = rows.size, rows.index
        kr = xf.shape[2] // r
        g = gy.float()
        gxf = torch.empty(xf.shape, dtype=torch.float32, device=xf.device)
        for t, panel in enumerate(panels):
            src = (i - t) % r
            gxf[..., src * kr:(src + 1) * kr] = g @ panel.float().t()
        gx = C.reduce_scatter_blocks(gxf, 2, cols) if cols.size > 1 else gxf
        g2 = g.flatten(0, 1)
        gw = None
        for t in range(r - 1, -1, -1):
            # the panel row i held at hop t is row (i − t)'s: its part here
            # joins the sum that row i + 1 passed back, and goes on to i − 1
            src = (i - t) % r
            part = xf[..., src * kr:(src + 1) * kr].flatten(0, 1).float(
                ).t() @ g2
            gw = part if gw is None else part + gw
            if t > 0:
                gw = C.ring_shift(gw, rows, -1)
        return gx.to(xf.dtype), gw.to(ctx.w_dtype), None, None


def summa_matmul(x: Sharded, w: Sharded) -> Sharded:
    """``x @ w`` as SUMMA on the model grid. x: (B, S, K); w: (K, N); each
    is re-laid out first as SUMMA holds it, x split (batch as it is,
    model_r, model_c) and w (model_r, model_c): a weight stored otherwise
    (FFN's w_out and attention's wo, which the rules table places
    transposed) is resharded at entry, as GSPMD does in the reference.
    Returns (B, S, N) split (batch, model_r, model_c). Counts its calls in
    ``summa_matmul.calls``."""
    mesh = x.mesh
    row, col = _split(mesh, ROW_AXIS), _split(mesh, COL_AXIS)
    x = x.relayout((x.place[0], row, col))
    w = w.relayout((row, col))
    y = _Summa.apply(x.local, w.local, mesh.group(ROW_AXIS),
                     mesh.group(COL_AXIS))
    summa_matmul.calls += 1
    return Sharded(y, x.shape[:2] + w.shape[1:], (x.place[0], row, col),
                   mesh)


summa_matmul.calls = 0


def _merge(t: Sharded, start: int, end: int) -> Sharded:
    """Dims [start, end) of ``t`` as one, row-major; the merged dim keeps
    the first one's placement (the others are gathered whole first)."""
    if any(t.place[start + 1:end]):
        t = t.relayout(t.place[:start + 1] + ((),) * (end - start - 1)
                       + t.place[end:])
    shape = t.shape[:start] + (math.prod(t.shape[start:end]),) + \
        t.shape[end:]
    return Sharded(t.local.flatten(start, end - 1), shape,
                   t.place[:start + 1] + t.place[end:], t.mesh)


def _unmerge(t: Sharded, dim: int, sizes: tuple[int, ...]) -> Sharded:
    """Dim ``dim`` of ``t`` as ``sizes``, row-major; the first keeps its
    placement."""
    return Sharded(t.local.unflatten(dim, (-1,) + tuple(sizes[1:])),
                   t.shape[:dim] + tuple(sizes) + t.shape[dim + 1:],
                   t.place[:dim + 1] + ((),) * (len(sizes) - 1)
                   + t.place[dim + 1:], t.mesh)


# ---------------------------------------------------------------------------
# Layer entry points (nn/ffn.py and nn/attention.py)
# ---------------------------------------------------------------------------

def ffn_ok(cfg, mesh, x_shape) -> bool:
    return (matmul_ok(mesh, x_shape, cfg.d_model, cfg.d_ff)
            and matmul_ok(mesh, x_shape, cfg.d_ff, cfg.d_model))


def ffn_apply(ffn, x: Sharded, act) -> Sharded:
    """The GLU FFN on the grid: act(x·w_in) ⊙ (x·w_gate) · w_out. The first
    products' output blocks are the last one's input blocks, so the chain
    moves no activation between them."""
    mesh = x.mesh
    h = summa_matmul(x, param_block(ffn.w_in, mesh))
    h = h.map(lambda a, g: act(a) * g,
              summa_matmul(x, param_block(ffn.w_gate, mesh)))
    return summa_matmul(h, param_block(ffn.w_out, mesh))


def qkv_ok(cfg, mesh, x_shape) -> bool:
    r, c = grid_shape(mesh)
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    return (matmul_ok(mesh, x_shape, cfg.d_model, cfg.n_heads * cfg.head_dim)
            and kv_dim % c == 0 and cfg.n_heads % c == 0
            and cfg.n_kv_heads % c == 0)


def attn_qkv(attn, x: Sharded) -> tuple[Sharded, Sharded, Sharded]:
    """The q, k and v projections on the grid: (B, S, D) → (B, S, H,
    head_dim) each, split (batch, model_r, model_c, whole). The head axes
    flatten into the product's N (c divides the heads, ``qkv_ok``, so the
    un-flatten is local); the bias and RoPE stay with the caller."""
    c = attn.cfg
    out = []
    for w, heads in ((attn.wq, c.n_heads), (attn.wk, c.n_kv_heads),
                     (attn.wv, c.n_kv_heads)):
        y = summa_matmul(x, _merge(param_block(w, x.mesh), 1, 3))
        out.append(_unmerge(y, 2, (heads, c.head_dim)))
    return tuple(out)


def out_ok(cfg, mesh, o_shape) -> bool:
    return matmul_ok(mesh, o_shape, cfg.n_heads * cfg.head_dim, cfg.d_model)


def attn_out(attn, o: Sharded) -> Sharded:
    """The output projection: (B, S, H, head_dim) → the (B, S, D) residual
    split (batch, model_r, model_c). Entering it re-splits the sequence
    over the grid rows (a local cut: it was whole for the attention)."""
    return summa_matmul(_merge(o, 2, 4),
                        _merge(param_block(attn.wo, o.mesh), 0, 2))
