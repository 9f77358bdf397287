"""K2's bf16 tensor-core path, emulated on the CPU in float64.

``vibravox_tpu_torch/ops/csrc/fused_residual_bwd.cu`` runs the bf16 residual
stack backward on ``mma.sync.aligned.m16n8k16`` with fragments loaded by
``ldmatrix`` from time-major bf16 planes ``[row][C + 8]`` in shared memory:
``unit_forward_mma_kernel`` recomputes x1 and x2, ``unit_backward_mma_kernel``
runs each unit's channel products (h1, h2, dh1 = Wp^T dh2, dx = Wd^T dh1
shifted by tap) with ``ldmatrix.x4`` and its gram products (dWp, dWd) with
``ldmatrix.trans``, and ``reduce_partials_kernel`` sums the blocks' partials.
A CUDA kernel cannot run here, so this file writes out the same index
arithmetic in torch: shared memory as flat cells with the planes' padded row
stride, the ``ldmatrix`` lane maps (plain and transposed), the m16n8k16
fragment maps, the weight layout launch and the double-buffered chunk
stream, each warp's tiles in the channel and gram products, the reflect
fold terms of dx, the persistent grid's per-block partials and their
block-order sum.  Shared memory and the partials start as NaN, so a read of
a cell the kernel never wrote shows in the result.

The walks are held to ``torch.einsum`` and to autograd of a plain unit at
1e-12 of scale, every output cell must be written exactly once, every
``ldmatrix`` row address must be 16-byte aligned and the 8 rows of every
phase must fall in 8 distinct 16-byte bank groups.  With the kernel's bf16
rounding the whole stack backward is held to the float32 plain backward at
K2's bf16 bars.  No JAX.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from vibravox_tpu_torch.ops.fused_residual import plain_residual_stack_backward
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

APAD = 8  # kApad: bf16 pad of every plane and weight row
DILS = (1, 3, 9)
SLOTS = 8  # kSlots: Wd taps 0-2, Wp, then both transposed
SLOT_WD, SLOT_WP, SLOT_WDT, SLOT_WPT = 0, 3, 4, 7
# MmaPlan<C>: TILE (owned rows), KC (reduction channels a chunk), STAGES
# (weight buffers in the ring), WARPS (a block's), BLOCKS (blocks per SM
# that __launch_bounds__ promises)
PLANS = {32: (224, 32, 2, 8, 2), 64: (256, 64, 2, 16, 1), 128: (160, 32, 3, 16, 1)}
NW = 2  # WarpTiles::kNw: n8 tiles a warp takes in a channel product
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024

LANE = torch.arange(32)
G, Q = LANE >> 2, LANE & 3
NAN = float("nan")


class Geometry:
    """Geometry<C, D>: a block's planes at dilation d, in elements."""

    def __init__(self, c, d):
        self.tile, self.kc, self.stages, self.warps, self.blocks = PLANS[c]
        self.s = c + APAD
        self.own_mt = self.tile // 16
        self.win_mt = -(-(self.tile + 2 * d) // 16)
        self.win_rows = 16 * self.win_mt
        self.x_rows = self.win_rows + 2 * d
        self.wb = c * (self.kc + APAD)
        self.bwd_elems = (self.x_rows + 2 * self.win_rows) * self.s + self.stages * self.wb
        self.fwd_elems = (self.tile + 2 * d + self.tile) * self.s + self.stages * self.wb


def blocks_per_sm(smem_bytes):
    return SMEM_PER_SM // (smem_bytes + SMEM_RESERVED)


def promised_blocks(c, smem_bytes):
    return min(blocks_per_sm(smem_bytes), PLANS[c][4])


# ---- the fragment maps of m16n8k16 (PTX ISA), lane = 4 g + q --------------

def a_map():
    """(row, col) of each lane's 8 A values (16 x 16, m x k), in register
    order a0.lo, a0.hi, a1.lo, ..., a3.hi: (32, 8) each."""
    rows = torch.stack([G, G, G + 8, G + 8, G, G, G + 8, G + 8], 1)
    cols = torch.stack([2 * Q, 2 * Q + 1, 2 * Q, 2 * Q + 1, 2 * Q + 8, 2 * Q + 9, 2 * Q + 8, 2 * Q + 9], 1)
    return rows, cols


def b_map():
    """(k, n) of each lane's 4 B values (16 x 8), b0.lo, b0.hi, b1.lo, b1.hi."""
    return torch.stack([2 * Q, 2 * Q + 1, 2 * Q + 8, 2 * Q + 9], 1), torch.stack([G] * 4, 1)


def c_map():
    """(m, n) of each lane's 4 C values (16 x 8), c0..c3."""
    return torch.stack([G, G, G + 8, G + 8], 1), torch.stack([2 * Q, 2 * Q + 1, 2 * Q, 2 * Q + 1], 1)


def _gather(rows, cols, shape):
    """For each cell of a matrix (row-major), the (lane, value) slot the map
    puts there: the fragments to the matrix by one gather."""
    slot = torch.full(shape, -1, dtype=torch.long)
    slot[rows, cols] = torch.arange(rows.numel()).reshape(rows.shape)
    return slot.reshape(-1)


A_SLOT, B_SLOT, C_SLOT = _gather(*a_map(), (16, 16)), _gather(*b_map(), (16, 8)), _gather(*c_map(), (16, 8))
C_CELL = c_map()[0] * 8 + c_map()[1]  # each C lane value's cell


def mma(a, b, c):
    """One m16n8k16 step on lane fragments a (..., 32, 8), b (..., 32, 4),
    c (..., 32, 4): the matrices the maps describe, C + A B, back to lanes."""
    return mma_steps(a[None], b[None], c)


def mma_steps(a, b, c):
    """Several m16n8k16 steps into one accumulator: a (steps, ..., 32, 8),
    b (steps, ..., 32, 4), c (..., 32, 4); C + sum over the steps of A B."""
    am = a.reshape(*a.shape[:-2], 256)[..., A_SLOT].reshape(*a.shape[:-2], 16, 16)
    bm = b.reshape(*b.shape[:-2], 128)[..., B_SLOT].reshape(*b.shape[:-2], 16, 8)
    cm = c.reshape(*c.shape[:-2], 128)[..., C_SLOT].reshape(*c.shape[:-2], 16, 8)
    return (cm + (am @ bm).sum(0)).reshape(*c.shape[:-2], 128)[..., C_CELL]


# ---- ldmatrix ----------------------------------------------------------------

# the row (time or weight row) and column offsets each lane addresses
A_R, A_C = (LANE & 7) + ((LANE >> 3) & 1) * 8, (LANE >> 4) * 8  # channel products' A
B_R, B_C = (LANE & 7) + (LANE >> 4) * 8, ((LANE >> 3) & 1) * 8  # their B: n-tile pairs
AT_R, AT_C = (LANE & 7) + (LANE >> 4) * 8, ((LANE >> 3) & 1) * 8  # grams' A, transposed
BT_R, BT_C = (LANE & 7) + ((LANE >> 3) & 1) * 8, (LANE >> 4) * 8  # grams' B, transposed


class Smem:
    """Flat shared memory of bf16 cells (held in float64, NaN until written),
    with the byte address of every ldmatrix phase's rows recorded."""

    def __init__(self, n_elems):
        self.cells = torch.full((n_elems,), NAN, dtype=torch.float64)
        self.phases = []  # (..., 8) byte addresses of the rows of one phase

    def ldmatrix(self, elem, trans=False, n_mats=4):
        """elem (..., 32): each lane's row address in elements; lane l gives
        row l % 8 of matrix l / 8 (lanes 0-15 for two matrices).  Register r
        of lane 4 g + q receives row g, columns 2q and 2q + 1 of matrix r, or
        transposed rows 2q and 2q + 1 of column g.  Returns (..., 32, 2 n_mats)
        in the register order r0.lo, r0.hi, r1.lo, ..."""
        used = elem[..., : 8 * n_mats]
        assert (used >= 0).all() and (used < self.cells.numel()).all(), "ldmatrix reads outside shared memory"
        self.phases.append((2 * used).reshape(-1, 8))
        r = torch.arange(n_mats)
        if trans:
            src = elem[..., 8 * r[None, :, None] + 2 * Q[:, None, None] + torch.arange(2)]  # (..., lane, r, 2)
            idx = src + G[:, None, None]
        else:
            src = elem[..., 8 * r[None, :] + G[:, None]]  # (..., lane, r)
            idx = src[..., None] + 2 * Q[:, None, None] + torch.arange(2)
        return self.cells[idx].reshape(*elem.shape[:-1], 32, 2 * n_mats)


def assert_conflict_free(phases):
    addrs = torch.cat(phases)
    assert (addrs % 16 == 0).all(), "an ldmatrix row address is not 16-byte aligned"
    groups = (addrs // 16) % 8
    assert ((groups[:, :, None] == groups[:, None, :]).sum(-1) == 1).all(), \
        "an ldmatrix phase has two rows in one bank group"


def bf16(v):
    """round to bf16 (the kernel's __float2bfloat16 of an f32 value)"""
    return v.to(torch.bfloat16).to(v.dtype)


def _identity(v):
    return v


def reflect(t, t_len):
    t = t.abs()
    return torch.where(t > t_len - 1, 2 * (t_len - 1) - t, t)


def reflect_clamped(t, t_len):
    return reflect(t, t_len).clamp(0, t_len - 1)


# ---- the weights: the layout launch and the chunk stream ----------------------

def layout_unit_weights(kernels):
    """layout_unit_weights_kernel: wt[unit][slot][n][k], element by element."""
    c = kernels[0][0].shape[0]
    cc = c * c
    e = torch.arange(3 * SLOTS * cc)
    u, r = e // (SLOTS * cc), e % (SLOTS * cc)
    slot = r // cc
    n, k = (r % cc) // c, r % c
    transposed = slot >= SLOT_WDT
    tap = torch.where(transposed, slot - SLOT_WDT, slot)
    o, i = torch.where(transposed, k, n), torch.where(transposed, n, k)
    wd = torch.stack([wd.reshape(-1) for wd, _ in kernels])  # (unit, (o i k))
    wp = torch.stack([wp.reshape(-1) for _, wp in kernels])
    val = torch.where(tap < 3, wd[u, ((o * c + i) * 3 + tap.clamp(max=2))], wp[u, o * c + i])
    return val.reshape(3, SLOTS, c, c)


def chunk_of(c, n):
    """WeightStream::chunk: the slot and first reduction channel of chunk n."""
    kc = PLANS[c][1]
    cpc = c // kc
    if n < 3 * cpc:
        return SLOT_WD + n % 3, (n // 3) * kc
    if n < 4 * cpc:
        return SLOT_WP, (n - 3 * cpc) * kc
    if n < 5 * cpc:
        return SLOT_WPT, (n - 4 * cpc) * kc
    return SLOT_WDT + (n - 5 * cpc) % 3, ((n - 5 * cpc) // 3) * kc


class Stream:
    """WeightStream: a block's chunk m (chunk m % chunks of a tile) lands in
    ring buffer m % stages; start() issues chunks 0 .. stages - 2, acquire()
    gives chunk m and issues chunk m + stages - 1 if the block has it
    (m_end = its tiles x chunks).  A tile's chunks start at `start`."""

    def __init__(self, sm, c, wt_unit, ring, backward, m_end, start=0):
        self.sm, self.c, self.wt, self.ring, self.m_end, self.start = sm, c, wt_unit, ring, m_end, start
        _, self.kc, self.stages, _, _ = PLANS[c]
        self.wb = c * (self.kc + APAD)
        self.chunks = (8 if backward else 4) * (c // self.kc)
        self.m = 0
        self.issued = []  # the tile chunks, in the order issued
        for m in range(self.stages - 1):
            self.issue(m)

    def issue(self, m):
        if m >= self.m_end:
            return
        n = (self.start + m) % self.chunks
        slot, k0 = chunk_of(self.c, n)
        rows = torch.arange(self.c)[:, None] * (self.kc + APAD) + torch.arange(self.kc)[None, :]
        self.sm.cells[self.ring + (m % self.stages) * self.wb + rows] = self.wt[slot, :, k0 : k0 + self.kc]
        self.issued.append(n)

    def acquire(self):
        assert self.m < self.m_end, "a chunk past the block's last"
        self.issue(self.m + self.stages - 1)
        w = self.ring + (self.m % self.stages) * self.wb
        self.m += 1
        return w


# ---- the products ---------------------------------------------------------------

def warp_tiles(c, nmt):
    """WarpTiles<C, NMT>: (kWn, kWm, kMw, kNw)."""
    warps = PLANS[c][3]
    wn = c // (8 * NW)
    wm = warps // wn
    return wn, wm, -(-nmt // wm), NW


def channel_product(sm, stream, c, nmt, kt, plane, plane_rows, a_row0, tap_step):
    """channel_product<C, NMT, KT>: the warps' accumulators (warp, MW, NW,
    32, 4) and, for the epilogue, each accumulator's plane row and channel
    and whether its m-tile is live."""
    wn, wm, mw, nw = warp_tiles(c, nmt)
    kc, s, ws, warps = PLANS[c][1], c + APAD, PLANS[c][1] + APAD, PLANS[c][3]
    warp = torch.arange(warps)
    n0 = (warp % wn) * nw * 8
    mt = (warp // wn)[:, None] + wm * torch.arange(mw)[None, :]  # (warp, i)
    live = mt < nmt  # warp-uniform
    acc = torch.zeros(warps, mw, nw, 32, 4, dtype=torch.float64)
    pairs = torch.arange(nw // 2)
    steps = torch.arange(0, kc, 16)[:, None, None, None]  # a chunk's k16 steps, taken together
    for k0 in range(0, c, kc):
        for k in range(kt):
            w = stream.acquire()
            row0 = a_row0 + k * tap_step
            b = sm.ldmatrix(w + (n0[:, None, None] + 16 * pairs[None, :, None] + B_R) * ws + steps + B_C)
            b = b.reshape(-1, warps, nw // 2, 32, 2, 4).transpose(3, 4).reshape(-1, warps, nw, 32, 4)
            # a warp past the last m-tile loads that one again and drops it
            rows = row0 + 16 * mt.clamp(max=nmt - 1)[..., None] + A_R  # (warp, i, lane)
            assert rows.min() >= 0 and rows.max() < plane_rows, "A reads outside its plane"
            a = sm.ldmatrix(plane + rows * s + k0 + steps + A_C)  # (step, warp, i, 32, 8)
            new = mma_steps(a[:, :, :, None].expand(-1, -1, -1, nw, -1, -1),
                            b[:, :, None].expand(-1, -1, mw, -1, -1, -1), acc)
            acc = torch.where(live[:, :, None, None, None], new, acc)
    cr, cc = c_map()
    row = (16 * mt)[:, :, None, None, None] + cr  # (warp, i, 1, lane, e)
    ch = n0[:, None, None, None, None] + 8 * torch.arange(nw)[None, None, :, None, None] + cc
    keep = live[:, :, None, None, None].expand_as(acc)
    return acc[keep], row.expand_as(acc)[keep], ch.expand_as(acc)[keep]


def gram(sm, c, ksteps, a_plane, a_row0, b_plane, b_row0):
    """gram<C, KSTEPS> and the cells store_gram gives each value: the
    warps' sums and their (o, i), flat."""
    warps = PLANS[c][3]
    mg, ng = c // 16 // (warps // 4), c // 32  # (warps / 4) x 4 warps
    s = c + APAD
    warp = torch.arange(warps)
    o0, i0 = (warp >> 2) * 16 * mg, (warp & 3) * (c // 4)
    acc = torch.zeros(warps, mg, ng, 32, 4, dtype=torch.float64)
    ks = 16 * torch.arange(ksteps)[:, None, None, None]  # the k16 steps, taken together
    m = torch.arange(mg)
    fa = sm.ldmatrix(a_plane + (a_row0 + ks + AT_R) * s + o0[:, None, None] + 16 * m[None, :, None] + AT_C,
                     trans=True)  # (step, warp, m, 32, 8)
    if ng == 1:
        fb = sm.ldmatrix(b_plane + (b_row0 + ks[..., 0] + BT_R) * s + i0[:, None], trans=True, n_mats=2)[:, :, None]
    else:
        p = torch.arange(ng // 2)
        fb = sm.ldmatrix(b_plane + (b_row0 + ks + BT_R) * s + i0[:, None, None] + 16 * p[None, :, None] + BT_C,
                         trans=True)
        fb = fb.reshape(ksteps, warps, ng // 2, 32, 2, 4).transpose(3, 4).reshape(ksteps, warps, ng, 32, 4)
    acc = mma_steps(fa[:, :, :, None].expand(-1, -1, -1, ng, -1, -1), fb[:, :, None].expand(-1, -1, mg, -1, -1, -1),
                    acc)
    cr, cc = c_map()
    o = o0[:, None, None, None, None] + 16 * torch.arange(mg)[None, :, None, None, None] + cr
    i = i0[:, None, None, None, None] + 8 * torch.arange(ng)[None, None, :, None, None] + cc
    return acc.reshape(-1), o.expand_as(acc).reshape(-1), i.expand_as(acc).reshape(-1)


def store_gram(part, writes, slot, vals, o, i, first):
    """store_gram: written on the block's first tile, added to after."""
    if first:
        part[slot, o, i] = vals
    else:
        part[slot, o, i] = part[slot, o, i] + vals
    writes[slot].index_put_((o, i), torch.ones_like(o), accumulate=True)


# ---- the kernels --------------------------------------------------------------

def load_plane(sm, plane, c, xb, rows, t_first):
    """load_plane: rows of a time-major plane from NCW xb (C, T)."""
    j = torch.arange(rows)
    t = reflect_clamped(t_first + j, xb.shape[1])
    sm.cells[plane + j[:, None] * (c + APAD) + torch.arange(c)[None, :]] = xb[:, t].T


def unit_forward(x, wt_unit, d, slope, rnd, checks):
    """unit_forward_mma_kernel over every (tile, batch row) block: y = x +
    leaky(Wp . Wd * x), rounded as the kernel rounds."""
    b_n, c, t_len = x.shape
    gm = Geometry(c, d)
    tile, s = gm.tile, gm.s
    y = torch.full_like(x, NAN)
    for bi in range(b_n):
        for t0 in range(0, t_len, tile):
            sm = Smem(gm.fwd_elems)
            xs, hs = 0, (tile + 2 * d) * s
            wbuf = hs + tile * s
            stream = Stream(sm, c, wt_unit, wbuf, backward=False, m_end=4 * (c // gm.kc))
            load_plane(sm, xs, c, x[bi], tile + 2 * d, t0 - d)
            v, row, ch = channel_product(sm, stream, c, gm.own_mt, 3, xs, tile + 2 * d, 0, d)
            sm.cells[hs + row * s + ch] = rnd(v)
            v, row, ch = channel_product(sm, stream, c, gm.own_mt, 1, hs, tile, 0, 0)
            cells = xs + (row + d) * s + ch
            sm.cells[cells] = rnd(sm.cells[cells] + rnd(torch.where(v >= 0, v, slope * v)))
            n_own = min(tile, t_len - t0)
            p = torch.arange(n_own)
            y[bi, :, t0 : t0 + n_own] = sm.cells[xs + (p[None, :] + d) * s + torch.arange(c)[:, None]]
            checks.setdefault("phases", []).extend(sm.phases)
    return y


def unit_backward(x, g, wt_unit, wd, d, slope, rnd, rnd_out, blocks, checks, fold=True):
    """unit_backward_mma_kernel on a persistent grid of `blocks` blocks and
    reduce_partials: dx (B, C, T) and dW as (dWd (C, C, 3), dWp (C, C, 1))."""
    b_n, c, t_len = x.shape
    gm = Geometry(c, d)
    tile, s = gm.tile, gm.s
    tiles_per_row = -(-t_len // tile)
    n_tiles = b_n * tiles_per_row
    blocks = min(blocks, n_tiles)
    dx = torch.full_like(x, NAN)
    dx_writes = torch.zeros(x.shape, dtype=torch.long)
    partials = torch.full((blocks, 4, c, c), NAN, dtype=torch.float64)
    for blk in range(blocks):
        sm = Smem(gm.bwd_elems)
        xs = 0
        hs = xs + gm.x_rows * s
        ds = hs + gm.win_rows * s
        wbuf = ds + gm.win_rows * s
        tiles = range(blk, n_tiles, blocks)
        stream = Stream(sm, c, wt_unit, wbuf, backward=True, m_end=len(tiles) * 8 * (c // gm.kc))
        part = partials[blk]
        first = True
        for tile_i in tiles:
            writes = torch.zeros(4, c, c, dtype=torch.long)
            bi, t0 = tile_i // tiles_per_row, (tile_i % tiles_per_row) * tile
            load_plane(sm, xs, c, x[bi], gm.x_rows, t0 - 2 * d)
            # h1 over the window
            v, row, ch = channel_product(sm, stream, c, gm.win_mt, 3, xs, gm.x_rows, 0, d)
            sm.cells[hs + row * s + ch] = rnd(v)
            h1_cells = row * c + ch
            # h2 -> dh2 = G * leaky'(h2), G = 0 outside [0, T)
            v, row, ch = channel_product(sm, stream, c, gm.win_mt, 1, hs, gm.win_rows, 0, 0)
            t = t0 - d + row
            inside = (t >= 0) & (t < t_len)
            gv = torch.where(inside, g[bi, ch, t.clamp(0, t_len - 1)], torch.zeros((), dtype=g.dtype))
            sm.cells[ds + row * s + ch] = rnd(torch.where(v >= 0, gv, slope * gv))
            # dWp
            vals, o, i = gram(sm, c, gm.own_mt, ds, d, hs, d)
            store_gram(part, writes, 3, vals, o, i, first)
            # dh1 = Wp^T dh2 over the window
            v, row, ch = channel_product(sm, stream, c, gm.win_mt, 1, ds, gm.win_rows, 0, 0)
            sm.cells[hs + row * s + ch] = rnd(v)
            assert torch.equal(torch.sort(row * c + ch).values, torch.sort(h1_cells).values)
            # dWd per tap
            for k in range(3):
                vals, o, i = gram(sm, c, gm.own_mt, hs, d, xs, (k + 1) * d)
                store_gram(part, writes, k, vals, o, i, first)
            # dx at the owned rows, plus the reflect pad's transpose
            v, p, i = channel_product(sm, stream, c, gm.own_mt, 3, hs, gm.win_rows, 2 * d, -d)
            sv = t0 + p
            keep = sv < t_len
            v, p, i, sv = v[keep], p[keep], i[keep], sv[keep]
            if fold:
                for k, hit, time in ((0, (sv >= 1) & (sv <= d), d - sv),
                                     (2, (sv >= t_len - 1 - d) & (sv <= t_len - 2), 2 * (t_len - 1) - sv - d)):
                    if hit.any():
                        rows = (time - t0 + d)[hit]  # window row of that time
                        h = sm.cells[hs + rows[:, None] * s + torch.arange(c)[None, :]]  # (n, o)
                        v = v.clone()
                        v[hit] = v[hit] + (wd[:, i[hit], k].T * h).sum(1)
            dx[bi, i, sv] = rnd_out(g[bi, i, sv] + v)
            dx_writes[bi].index_put_((i, sv), torch.ones_like(i), accumulate=True)
            assert torch.equal(writes, torch.ones_like(writes)), "a gram cell written other than once a tile"
            first = False
        checks.setdefault("phases", []).extend(sm.phases)
        checks.setdefault("chunks", []).append(stream.issued)
    checks["dx_writes"] = dx_writes
    # reduce_partials<true>: the block-order sum, permuted from [tap][o][i]
    summed = torch.zeros(4 * c * c, dtype=torch.float64)
    for blk in range(blocks):
        summed = summed + partials[blk].reshape(-1)
    out = torch.full((4 * c * c,), NAN, dtype=torch.float64)
    e = torch.arange(4 * c * c)
    slot, oi = e // (c * c), e % (c * c)
    out[torch.where(slot < 3, oi * 3 + slot, 3 * c * c + oi)] = summed
    return dx, (out[: 3 * c * c].reshape(c, c, 3), out[3 * c * c :].reshape(c, c, 1))


def stack_backward(x, kernels, g, slope=0.01, rnd=_identity, blocks=3, checks=None):
    """K2's bf16 path end to end: the weight layout, x1 and x2 recomputed,
    units 2, 1, 0 backward, dx rounded to bf16 at the end (with rnd=bf16)."""
    checks = {} if checks is None else checks
    wt = layout_unit_weights(kernels)
    x1 = unit_forward(x, wt[0], 1, slope, rnd, checks)
    x2 = unit_forward(x1, wt[1], 3, slope, rnd, checks)
    xs, gs, dws = (x, x1, x2), g, [None] * 3
    for u in (2, 1, 0):
        gs, dws[u] = unit_backward(xs[u], gs, wt[u], kernels[u][0], DILS[u], slope, rnd,
                                   rnd if u == 0 else _identity, blocks, checks)
    return gs, tuple(dws)


# ---- tests ----------------------------------------------------------------------

def _weights(c, seed, scale=None):
    gen = torch.Generator().manual_seed(seed)
    scale = 0.5 / math.sqrt(3 * c) if scale is None else scale
    return tuple((torch.randn(c, c, 3, generator=gen, dtype=torch.float64) * scale,
                  torch.randn(c, c, 1, generator=gen, dtype=torch.float64) * scale) for _ in range(3))


def test_fragment_maps_cover_each_cell_once():
    for (rows, cols), shape in ((a_map(), (16, 16)), (b_map(), (16, 8)), (c_map(), (16, 8))):
        seen = torch.zeros(shape, dtype=torch.long)
        seen.index_put_((rows.reshape(-1), cols.reshape(-1)), torch.ones(rows.numel(), dtype=torch.long),
                        accumulate=True)
        assert torch.equal(seen, torch.ones(shape, dtype=torch.long))


def test_one_mma_step_is_the_matrix_product():
    gen = torch.Generator().manual_seed(0)
    am = torch.randn(3, 16, 16, generator=gen, dtype=torch.float64)
    bm = torch.randn(3, 16, 8, generator=gen, dtype=torch.float64)
    cm = torch.randn(3, 16, 8, generator=gen, dtype=torch.float64)
    (ar, ac), (br, bc), (cr, cc) = a_map(), b_map(), c_map()
    out = mma(am[:, ar, ac], bm[:, br, bc], cm[:, cr, cc])
    assert (out - (cm + am @ bm)[:, cr, cc]).abs().max() <= 1e-12 * out.abs().max()


@pytest.mark.parametrize("load", ["a", "b_pair", "a_trans", "b_trans_pair", "b_trans_x2"])
def test_ldmatrix_lane_maps_give_the_mma_fragments(load):
    """Each way the kernels load a fragment, from a stored matrix with a
    padded row stride, gives the lane values the m16n8k16 maps name.  The
    channel products store A as [time][channel] and B as [n][k]; the grams
    store both as [time][channel] and read them transposed."""
    s = 128 + APAD
    gen = torch.Generator().manual_seed(1)
    stored = torch.randn(32, s, generator=gen, dtype=torch.float64)
    sm = Smem(32 * s)
    sm.cells[:] = stored.reshape(-1)
    (ar, ac), (br, bc) = a_map(), b_map()
    r0, c0 = 3, 40  # a row and column offset
    if load == "a":  # A[m][k] = stored[r0 + m][c0 + k]
        got = sm.ldmatrix((r0 + A_R) * s + c0 + A_C)
        want = stored[r0 + ar, c0 + ac]
    elif load == "b_pair":  # B of n-tile j: B[k][n] = stored[r0 + 8 j + n][c0 + k]
        got = sm.ldmatrix((r0 + B_R) * s + c0 + B_C).reshape(32, 2, 4).transpose(0, 1)
        want = torch.stack([stored[r0 + 8 * j + bc, c0 + br] for j in range(2)])
    elif load == "a_trans":  # A[m][k] = stored[r0 + k][c0 + m]
        got = sm.ldmatrix((r0 + AT_R) * s + c0 + AT_C, trans=True)
        want = stored[r0 + ac, c0 + ar]
    elif load == "b_trans_pair":  # B of n-tile j: B[k][n] = stored[r0 + k][c0 + 8 j + n]
        got = sm.ldmatrix((r0 + BT_R) * s + c0 + BT_C, trans=True).reshape(32, 2, 4).transpose(0, 1)
        want = torch.stack([stored[r0 + br, c0 + 8 * j + bc] for j in range(2)])
    else:  # one n-tile, lanes 0-15
        got = sm.ldmatrix((r0 + BT_R) * s + c0, trans=True, n_mats=2)
        want = stored[r0 + br, c0 + bc]
    assert torch.equal(got, want)
    assert_conflict_free(sm.phases)


@pytest.mark.parametrize("c", sorted(PLANS))
def test_weight_layout_and_chunk_stream(c):
    """The layout launch's slots are Wd's taps and Wp, then both transposed;
    a tile's chunks give each product every (n, k) of its slots once, in the
    products' order, in alternating buffers."""
    ks = _weights(c, seed=c)
    wt = layout_unit_weights(ks)
    for u, (wd, wp) in enumerate(ks):
        want = torch.cat([wd.permute(2, 0, 1), wp.permute(2, 0, 1),
                          wd.permute(2, 1, 0), wp.permute(2, 1, 0)])
        assert torch.equal(wt[u], want)
    kc = PLANS[c][1]
    gm = Geometry(c, 9)
    sm = Smem(gm.stages * gm.wb)
    chunks = 8 * (c // kc)
    stream = Stream(sm, c, wt[0], 0, backward=True, m_end=2 * chunks)  # two tiles
    seen = torch.zeros(SLOTS, c, c, dtype=torch.long)
    order = []
    for n in range(stream.chunks):
        w = stream.acquire()
        assert w == (n % gm.stages) * gm.wb
        slot, k0 = chunk_of(c, n)
        buf = sm.cells[w : w + gm.wb].reshape(c, kc + APAD)
        assert torch.equal(buf[:, :kc], wt[0, slot, :, k0 : k0 + kc])
        seen[slot, :, k0 : k0 + kc] += 1
        order.append(slot)
    assert torch.equal(seen, torch.ones_like(seen))
    cpc = c // kc
    assert order == [0, 1, 2] * cpc + [3] * cpc + [7] * cpc + [4, 5, 6] * cpc
    # in flight: the next tile's first chunks
    assert stream.issued == list(range(stream.chunks)) + list(range(gm.stages - 1))


PRODUCTS = {"h1": (SLOT_WD, 3), "h2": (SLOT_WP, 1), "dh1": (SLOT_WPT, 1), "dx": (SLOT_WDT, 3)}


@pytest.mark.parametrize("d", DILS)
@pytest.mark.parametrize("product", list(PRODUCTS))
@pytest.mark.parametrize("c", sorted(PLANS))
def test_channel_product_walk_is_the_product(c, product, d):
    """One product of unit_backward_mma_kernel over its m-tiles, fed from the
    chunk stream at that product's first chunk: h1 over the window (tap k
    reads x rows j + k d), h2 and dh1 over the window, dx over the owned rows
    (tap k reads dh1 rows p + (2 - k) d)."""
    gm = Geometry(c, d)
    first_slot, kt = PRODUCTS[product]
    start = {"h1": 0, "h2": 3, "dh1": 4, "dx": 5}[product] * (c // gm.kc)
    gen = torch.Generator().manual_seed(c + d)
    ks = _weights(c, seed=c + 7 * d, scale=1.0)
    wt = layout_unit_weights(ks)
    rows = gm.x_rows if product == "h1" else gm.win_rows
    plane = torch.randn(rows, c, generator=gen, dtype=torch.float64)
    sm = Smem(rows * gm.s + gm.stages * gm.wb)
    sm.cells[torch.arange(rows)[:, None] * gm.s + torch.arange(c)] = plane
    chunks = kt * (c // gm.kc)
    stream = Stream(sm, c, wt[1], rows * gm.s, backward=True, m_end=chunks, start=start)
    nmt, a_row0, step = {"h1": (gm.win_mt, 0, d), "h2": (gm.win_mt, 0, 0), "dh1": (gm.win_mt, 0, 0),
                         "dx": (gm.own_mt, 2 * d, -d)}[product]
    v, row, ch = channel_product(sm, stream, c, nmt, kt, 0, rows, a_row0, step)
    out = torch.full((16 * nmt, c), NAN, dtype=torch.float64)
    writes = torch.zeros(16 * nmt, c, dtype=torch.long)
    out[row, ch] = v
    writes.index_put_((row, ch), torch.ones_like(row), accumulate=True)
    assert torch.equal(writes, torch.ones_like(writes))
    w = wt[1, first_slot : first_slot + kt]  # (tap, n, k)
    taps = torch.stack([plane[a_row0 + k * step : a_row0 + k * step + 16 * nmt] for k in range(kt)])
    ref = torch.einsum("tjk,tnk->jn", taps, w)
    assert (out - ref).abs().max() <= 1e-12 * ref.abs().max()
    assert stream.issued == [start + m for m in range(chunks)]
    assert_conflict_free(sm.phases)


@pytest.mark.parametrize("d", DILS)
@pytest.mark.parametrize("c", sorted(PLANS))
def test_gram_walk_is_the_product(c, d):
    """dWp (dh2 and h1 at window rows d + p) and dWd (dh1 at d + p, x at
    p + (k + 1) d) over the owned rows of two tiles of one block, the second
    added to the first, in the [tap][o][i] partial."""
    gm = Geometry(c, d)
    gen = torch.Generator().manual_seed(10 * c + d)
    sm = Smem(gm.bwd_elems)
    xs, hs, ds = 0, gm.x_rows * gm.s, (gm.x_rows + gm.win_rows) * gm.s
    part = torch.full((4, c, c), NAN, dtype=torch.float64)
    ref = torch.zeros(4, c, c, dtype=torch.float64)
    own = slice(d, d + gm.tile)
    for first in (True, False):
        planes = {}
        for name, base, rows in (("x", xs, gm.x_rows), ("h", hs, gm.win_rows), ("d", ds, gm.win_rows)):
            planes[name] = torch.randn(rows, c, generator=gen, dtype=torch.float64)
            sm.cells[base + torch.arange(rows)[:, None] * gm.s + torch.arange(c)] = planes[name]
        writes = torch.zeros(4, c, c, dtype=torch.long)
        vals, o, i = gram(sm, c, gm.own_mt, ds, d, hs, d)
        store_gram(part, writes, 3, vals, o, i, first)
        for k in range(3):
            vals, o, i = gram(sm, c, gm.own_mt, hs, d, xs, (k + 1) * d)
            store_gram(part, writes, k, vals, o, i, first)
        assert torch.equal(writes, torch.ones_like(writes))
        ref[3] += planes["d"][own].T @ planes["h"][own]
        for k in range(3):
            ref[k] += planes["h"][own].T @ planes["x"][(k + 1) * d : (k + 1) * d + gm.tile]
    assert (part - ref).abs().max() <= 1e-12 * ref.abs().max()
    assert_conflict_free(sm.phases)


def _plain_unit(x, wd, wp, d, slope):
    h = F.conv1d(F.pad(x, (d, d), mode="reflect"), wd, dilation=d)
    return x + F.leaky_relu(F.conv1d(h, wp), slope)


def _lengths(c):
    # a first and a ragged last tile over 2 rows, so one of the 3 blocks
    # takes two tiles; short rows where one tile is first and last and the
    # fold ranges overlap (T = 10)
    return {"tiles": (2, PLANS[c][0] + 37), "short": (3, 10)}


@pytest.mark.parametrize("length", ["tiles", "short"])
@pytest.mark.parametrize("d", DILS)
@pytest.mark.parametrize("c", sorted(PLANS))
def test_unit_backward_walk_is_autograd(c, d, length):
    """One unit's backward on a persistent grid of 3 blocks: dx (the mma
    product plus the fold terms) and the dW partials' block-order sum against
    autograd of one plain unit; every dx cell written once; every chunk
    issued in order across a block's tiles.  Without the fold terms dx is
    wrong at the edges."""
    b, t_len = _lengths(c)[length]
    slope = 0.01
    gen = torch.Generator().manual_seed(c + d + t_len)
    x = torch.randn(b, c, t_len, generator=gen, dtype=torch.float64)
    g = torch.randn(b, c, t_len, generator=gen, dtype=torch.float64)
    (wd, wp), *_ = _weights(c, seed=c * d, scale=1.0 / c)
    xr, wdr, wpr = (v.clone().requires_grad_(True) for v in (x, wd, wp))
    ref_dx, ref_wd, ref_wp = torch.autograd.grad(_plain_unit(xr, wdr, wpr, d, slope), (xr, wdr, wpr), g)
    wt = layout_unit_weights(((wd, wp),) * 3)[0]
    checks = {}
    dx, (dwd, dwp) = unit_backward(x, g, wt, wd, d, slope, _identity, _identity, 3, checks)
    assert torch.equal(checks["dx_writes"], torch.ones_like(checks["dx_writes"]))
    for got, ref in ((dx, ref_dx), (dwd, ref_wd), (dwp, ref_wp)):
        assert (got - ref).abs().max() <= 1e-12 * ref.abs().max()
    chunks = 8 * (c // PLANS[c][1])
    for issued in checks["chunks"]:  # each block's, over its tiles
        assert len(issued) % chunks == 0 and issued == list(range(chunks)) * (len(issued) // chunks)
    assert_conflict_free(checks["phases"])
    if length == "tiles" and d == 9:
        unfolded, _ = unit_backward(x, g, wt, wd, d, slope, _identity, _identity, 3, {}, fold=False)
        assert (unfolded - ref_dx).abs().max() > 1e-3 * ref_dx.abs().max()


@pytest.mark.parametrize("d", DILS[:2])
@pytest.mark.parametrize("c", sorted(PLANS))
def test_unit_forward_walk_is_the_plain_unit(c, d):
    """unit_forward_mma_kernel (the recompute of x1 at d = 1 and x2 at d = 3)
    over a first, an interior and a ragged last tile."""
    t_len = 2 * PLANS[c][0] + 37
    gen = torch.Generator().manual_seed(c * d)
    x = torch.randn(2, c, t_len, generator=gen, dtype=torch.float64)
    (wd, wp), *_ = _weights(c, seed=c + d, scale=1.0 / c)
    wt = layout_unit_weights(((wd, wp),) * 3)[0]
    checks = {}
    y = unit_forward(x, wt, d, 0.01, _identity, checks)
    ref = _plain_unit(x, wd, wp, d, 0.01)
    assert (y - ref).abs().max() <= 1e-12 * ref.abs().max()
    assert_conflict_free(checks["phases"])


@pytest.mark.parametrize("c", sorted(PLANS))
def test_shared_memory_fits_the_blocks_per_sm(c):
    """Geometry<C, D>::kBwdSmem and kFwdSmem at every dilation the kernels
    take, and the blocks per SM they leave (228 KB an SM, 1 KB reserved a
    block): every __launch_bounds__ promises the plan's blocks (2 / 1 / 1 at
    C = 32 / 64 / 128), which shared memory allows; at d = 9 the backward's
    planes and weight ring are 68 / 145 / 192 KB and its recomputed halo
    (whole m-tiles) 6 / 5 / 8% of the owned rows' work."""
    for d in DILS:
        gm = Geometry(c, d)
        assert promised_blocks(c, 2 * gm.bwd_elems) == gm.blocks
        assert promised_blocks(c, 2 * gm.fwd_elems) == gm.blocks
    gm = Geometry(c, 9)
    assert round(2 * gm.bwd_elems / 1000) == {32: 68, 64: 145, 128: 192}[c]
    # per tile, in m16 steps: h1 3, h2 1, dh1 1 over the window; dx 3 and
    # the grams 4 over the owned rows
    halo = 5 * (gm.win_rows - gm.tile) / (12 * gm.tile)
    assert round(100 * halo) == {32: 6, 64: 5, 128: 8}[c]


def test_stack_backward_in_bf16_is_within_k2_tolerance():
    """The whole bf16 walk, rounding x1, x2, h1, dh2, dh1 and dx to bf16 as
    the kernels do, on bf16-valued inputs, against the float32 plain
    backward at K2's bf16 bars (dx 5e-2, dW 1e-1 of scale), over at least
    1000 (batch, time) rows, where the card holds dW too."""
    c, t_len = 32, 700
    gen = torch.Generator().manual_seed(c + t_len)
    x = bf16(torch.randn(2, c, t_len, generator=gen, dtype=torch.float64) * 0.5)
    g = torch.randn(2, c, t_len, generator=gen, dtype=torch.float64) * 0.1
    ks = tuple((bf16(wd), bf16(wp)) for wd, wp in _weights(c, seed=c))
    dx, dws = stack_backward(x, ks, g, rnd=bf16)
    ref_dx, ref_dws = plain_residual_stack_backward(
        x.float(), tuple((wd.float(), wp.float()) for wd, wp in ks), g.float())
    assert torch.equal(dx, bf16(dx)), "dx leaves in bf16"
    assert ((dx - ref_dx).abs().max() / ref_dx.abs().max()).item() <= 5e-2
    for got, ref in zip([w for p in dws for w in p], [w for p in ref_dws for w in p]):
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-1
