"""K1's bf16 tensor-core path, emulated on the CPU in float64.

``vibravox_tpu_torch/ops/csrc/fused_residual.cu`` runs the bf16 residual
stack forward (``residual_stack_mma_kernel``) on ``mma.sync.aligned.m16n8k16``
with fragments loaded by ``ldmatrix.x4`` from time-major bf16 planes in
shared memory.  A CUDA kernel cannot run here, so this file writes out the
same index arithmetic in torch: the planes as flat shared memory with their
padded row stride, the weight relayout and the staged weight chunks, the
``ldmatrix`` lane maps (which lane gives which row address, which lane
receives which elements), the m16n8k16 fragment maps, each warp's tile walk
per unit, the reflect refill by rows, and the NCW <-> time-major transposes
of the load and the store.  Shared memory starts as NaN, so a read of a cell
the kernel never wrote shows in the result.

The walk is held to ``plain_residual_stack`` at 1e-12 of scale, every output
cell must be written exactly once, every ``ldmatrix`` row address must be
16-byte aligned, and the 8 row addresses of every ``ldmatrix`` phase must
fall in 8 distinct 16-byte bank groups (a layout that brings bank conflicts
back fails here, not on the card).  ``emulate_stack(..., rnd=bf16)`` rounds
at the kernel's points; ``tests/test_torch_fused_residual.py`` holds that to
the JAX package in bf16.  No JAX here.
"""

import pytest
import torch

from vibravox_tpu_torch.ops.fused_residual import plain_residual_stack
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)


WARPS = 8  # kThreads / 32
HALO = 13  # kHalo: 1 + 3 + 9
APAD = 8  # kApad: bf16 pad of every plane and weight row
DILS, HALOS = (1, 3, 9), (12, 9, 0)  # dil_of(u), halo_of(u)
# MmaPlan<C>: TILE, KC (input channels per weight chunk), MW m16 tiles and
# NW n8 tiles a warp
PLANS = {32: (232, 32, 2, 4), 64: (232, 32, 2, 8), 128: (104, 16, 2, 8)}

LANE = torch.arange(32)
G, Q = LANE >> 2, LANE & 3


def m_tiles(tile, u):
    return (tile + 2 * HALOS[u] + 15) // 16


def plane_rows(c):
    """mma_rows<C>: every row a unit's m-tiles read."""
    tile = PLANS[c][0]
    return max([tile + 2 * HALO] + [HALO - HALOS[u] + 16 * m_tiles(tile, u) + DILS[u] for u in range(3)])


def reflect(g, t_len):
    g = g.abs()
    return torch.where(g > t_len - 1, 2 * (t_len - 1) - g, g)


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


def mma(a, b, c):
    """One m16n8k16 step on lane fragments a (..., 32, 8), b (..., 32, 4),
    c (..., 32, 4): the matrices the maps describe, C + A B, back to lanes."""
    (ar, ac), (br, bc), (cr, cc) = a_map(), b_map(), c_map()
    am = a.new_zeros(*a.shape[:-2], 16, 16)
    bm = b.new_zeros(*b.shape[:-2], 16, 8)
    cm = c.new_zeros(*c.shape[:-2], 16, 8)
    am[..., ar, ac] = a
    bm[..., br, bc] = b
    cm[..., cr, cc] = c
    return (cm + am @ bm)[..., cr, cc]


# ---- ldmatrix.x4 -----------------------------------------------------------

class Smem:
    """Flat shared memory of bf16 cells (held in float64, NaN until written),
    with the byte address of every ldmatrix row recorded for the checks."""

    def __init__(self, n_elems):
        self.cells = torch.full((n_elems,), float("nan"), dtype=torch.float64)
        self.row_addrs = []  # (..., 4 phases, 8 rows) byte addresses

    def ldmatrix_x4(self, elem):
        """elem (..., 32): each lane's row address in elements.  Lane l gives
        row l % 8 of matrix l / 8; register r of lane 4 g + q receives row g,
        columns 2q and 2q + 1 of matrix r.  Returns (..., 32, 8) in the
        register order r0.lo, r0.hi, ..., r3.hi."""
        self.row_addrs.append((2 * elem).reshape(*elem.shape[:-1], 4, 8))
        src = elem[..., 8 * torch.arange(4)[None, :] + G[:, None]]  # (..., lane, r): row of matrix r
        idx = src[..., None] + 2 * Q[:, None, None] + torch.arange(2)  # (..., lane, r, lo/hi)
        return self.cells[idx].reshape(*elem.shape[:-1], 32, 8)


def a_lane_offsets():
    """(row, column) each lane addresses for an A m16 x k16 tile: matrices
    (rows 0-7 | 8-15) x (k 0-7 | 8-15) as a0..a3."""
    return (LANE & 7) + ((LANE >> 3) & 1) * 8, (LANE >> 4) * 8


def b_lane_offsets():
    """(weight row, column) each lane addresses for a pair of n8 tiles:
    matrices (n-tile 0 | 1) x (k 0-7 | 8-15), so registers b0, b1 of the
    first n-tile, then of the second."""
    return (LANE & 7) + (LANE >> 4) * 8, ((LANE >> 3) & 1) * 8


# ---- the kernel's walk ------------------------------------------------------

def _identity(v):
    return v


def bf16(v):
    """round to bf16 (the kernel's __float2bfloat16 of an f32 value)"""
    return v.to(torch.bfloat16).to(v.dtype)


def relayout(kernels):
    """relayout_weights_kernel: wt[unit][tap][o][i], taps 0-2 from wd and
    tap 3 from wp."""
    return torch.stack([torch.cat([wd.permute(2, 0, 1), wp.permute(2, 0, 1)]) for wd, wp in kernels])


def emulate_tile(xb, wt, t0, slope, rnd, writes):
    """One block: batch row xb (C, T) at tile start t0.  Returns the stored
    tile (C, n) and the block's shared memory (for the address checks);
    adds one to writes["x", u][row, channel] per xs cell unit u writes and
    to writes["h1", u] per hs cell."""
    c, t_len = xb.shape
    tile, kc, mw, nw = PLANS[c]
    s = c + APAD
    rows = plane_rows(c)
    wb = 3 * c * (kc + APAD)
    cpc = c // kc
    n_groups = c // (8 * nw)
    m_warps = WARPS // n_groups
    assert WARPS % n_groups == 0 and m_tiles(tile, 0) <= m_warps * mw
    sm = Smem(2 * rows * s + 2 * wb)
    xs, hs, wbuf = 0, rows * s, 2 * rows * s  # element offsets of the planes and buffers
    g0 = t0 - HALO
    width = tile + 2 * HALO

    # the load: (channel pair, row) per thread, transposed to time-major
    j = torch.arange(width)
    g = reflect(g0 + j, t_len).clamp(0, t_len - 1)
    ch = torch.arange(c)
    sm.cells[xs + j[:, None] * s + ch[None, :]] = xb[:, g].T

    # the weight stream: chunk n of unit n // (2 cpc), dilated then pointwise
    def issue(n):
        u, r = divmod(n, 2 * cpc)
        point = r >= cpc
        i0 = (r - cpc if point else r) * kc
        taps = [3] if point else [0, 1, 2]
        buf = wbuf + (n & 1) * wb
        for slot, tap in enumerate(taps):
            rr = torch.arange(c)[:, None] * (kc + APAD) + torch.arange(kc)[None, :]
            sm.cells[buf + slot * c * (kc + APAD) + rr] = wt[u, tap, :, i0 : i0 + kc]
        return buf

    warp = torch.arange(WARPS)
    n0 = (warp // m_warps) * nw * 8  # (warp,)
    mt0 = (warp % m_warps) * mw
    a_r, a_c = a_lane_offsets()
    b_r, b_c = b_lane_offsets()
    cr, cc = c_map()

    def product_step(acc, plane, a_row0, a_col, w, b_col, n_mt):
        """acc (warp, MW, NW, 32, 4) += A . B over one k16 step."""
        p = torch.arange(nw // 2)
        b_rows = n0[:, None, None] + 16 * p[None, :, None] + b_r  # (warp, pair, lane)
        b = sm.ldmatrix_x4(w + b_rows * (kc + APAD) + b_col + b_c)  # (warp, pair, 32, 8)
        b = b.reshape(WARPS, nw // 2, 32, 2, 4).transpose(2, 3).reshape(WARPS, nw, 32, 4)
        mt = mt0[:, None] + torch.arange(mw)[None, :]  # (warp, i)
        live = mt < n_mt  # warp-uniform: a tile of padding rows only is skipped
        a_rows = a_row0 + 16 * mt[..., None] + a_r  # (warp, i, lane)
        assert a_rows[live].min() >= 0 and a_rows[live].max() < rows, "A reads outside its plane"
        a_rows = torch.where(live[..., None], a_rows, torch.zeros((), dtype=torch.long))
        a = sm.ldmatrix_x4(plane + a_rows * s + a_col + a_c)  # (warp, i, 32, 8)
        if not live.all():
            sm.row_addrs[-1] = sm.row_addrs[-1][live]
        new = mma(a[:, :, None].expand(-1, -1, nw, -1, -1), b[:, None].expand(-1, mw, -1, -1, -1), acc)
        return torch.where(live[:, :, None, None, None], new, acc)

    n = 0
    for u in range(3):
        d, h = DILS[u], HALOS[u]
        j_lo, r_win = HALO - h, tile + 2 * h
        n_mt = m_tiles(tile, u)
        mt = mt0[:, None] + torch.arange(mw)[None, :]
        row_g = j_lo + 16 * mt[:, :, None, None, None] + cr  # (warp, i, 1, lane, e): C fragment rows
        col_o = n0[:, None, None, None, None] + 8 * torch.arange(nw)[None, None, :, None, None] + cc
        live = (mt < n_mt)[:, :, None, None, None].expand(-1, -1, nw, 32, 4)
        row_g, col_o = row_g.expand_as(live), col_o.expand_as(live)

        acc = torch.zeros(WARPS, mw, nw, 32, 4, dtype=torch.float64)
        for kci in range(cpc):
            buf = issue(n)
            n += 1
            for k in range(3):
                for ks in range(0, kc, 16):
                    acc = product_step(acc, xs, j_lo + (k - 1) * d, kci * kc + ks,
                                       buf + k * c * (kc + APAD), ks, n_mt)
        cells = hs + row_g[live] * s + col_o[live]
        sm.cells[cells] = rnd(acc[live])
        writes["h1", u].view(-1).index_put_((row_g[live] * c + col_o[live],),
                                         torch.ones_like(cells), accumulate=True)

        acc = torch.zeros_like(acc)
        for kci in range(cpc):
            buf = issue(n)
            n += 1
            for ks in range(0, kc, 16):
                acc = product_step(acc, hs, j_lo, kci * kc + ks, buf, ks, n_mt)
        keep = live & (row_g < j_lo + r_win)
        cells = xs + row_g[keep] * s + col_o[keep]
        v = acc[keep]
        sm.cells[cells] = rnd(sm.cells[cells] + rnd(torch.where(v >= 0, v, slope * v)))
        writes["x", u].view(-1).index_put_((row_g[keep] * c + col_o[keep],),
                                      torch.ones_like(cells), accumulate=True)

        # the reflect refill by whole rows
        if u < 2 and (t0 - h < 0 or t0 + tile + h > t_len):
            lo, hi = max(0, t0 - h), min(t_len - 1, t0 + tile + h - 1)
            jj = torch.arange(j_lo, j_lo + r_win)
            gt = g0 + jj
            out = (gt < 0) | (gt >= t_len)
            src = reflect(gt[out], t_len).clamp(lo, hi) - g0
            dst = jj[out]
            sm.cells[xs + dst[:, None] * s + ch] = sm.cells[xs + src[:, None] * s + ch]

    n_own = min(tile, t_len - t0)
    jo = HALO + torch.arange(n_own)
    return sm.cells[xs + jo[None, :] * s + ch[:, None]], sm


def emulate_stack(x, kernels, slope=0.01, rnd=_identity, checks=None):
    """The kernel's result for x (B, C, T) and torch-layout kernels, in x's
    dtype.  checks, a dict, collects the write counts and ldmatrix row
    addresses of every block."""
    b, c, t_len = x.shape
    tile = PLANS[c][0]
    wt = relayout(kernels)
    y = torch.full_like(x, float("nan"))
    y_writes = torch.zeros(b, c, t_len, dtype=torch.long)
    rows = plane_rows(c)
    for bi in range(b):
        for t0 in range(0, t_len, tile):
            writes = {(k, u): torch.zeros(rows, c, dtype=torch.long) for k in ("x", "h1") for u in range(3)}
            out, sm = emulate_tile(x[bi], wt, t0, slope, rnd, writes)
            y[bi, :, t0 : t0 + out.shape[1]] = out
            y_writes[bi, :, t0 : t0 + out.shape[1]] += 1
            if checks is not None:
                checks.setdefault("tiles", []).append((t0, writes))
                checks.setdefault("row_addrs", []).extend(sm.row_addrs)
    if checks is not None:
        checks["y_writes"] = y_writes
    return y


def _inputs(b, c, t, seed):
    gen = torch.Generator().manual_seed(seed)
    scale = 0.5 / c ** 0.5
    x = torch.randn(b, c, t, generator=gen, dtype=torch.float64) * 0.5
    ks = tuple((torch.randn(c, c, 3, generator=gen, dtype=torch.float64) * scale,
                torch.randn(c, c, 1, generator=gen, dtype=torch.float64) * scale) for _ in range(3))
    return x, ks


def _lengths(c):
    tile = PLANS[c][0]
    # one whole tile (first = last); a first, an interior and a ragged last
    # tile; a last tile of one sample; the shortest T and a short one
    return {"one_tile": tile, "three_tiles_ragged": 2 * tile + 37, "last_tile_of_1": tile + 1,
            "t10": 10, "t40": 40}


CASES = [(c, name) for c in PLANS for name in _lengths(c)]


@pytest.mark.parametrize("c,name", CASES, ids=[f"c{c}-{n}" for c, n in CASES])
def test_walk_is_the_plain_stack(c, name):
    t = _lengths(c)[name]
    b = 2 if t < 2 * PLANS[c][0] else 1
    x, ks = _inputs(b, c, t, seed=c + t)
    checks = {}
    y = emulate_stack(x, ks, checks=checks)
    ref = plain_residual_stack(x, ks)
    assert torch.equal(checks["y_writes"], torch.ones_like(checks["y_writes"]))
    assert (y - ref).abs().max() <= 1e-12 * ref.abs().max()

    tile = PLANS[c][0]
    for t0, writes in checks["tiles"]:
        for u in range(3):
            j_lo = HALO - HALOS[u]
            want = torch.zeros_like(writes["x", u])
            want[j_lo : j_lo + tile + 2 * HALOS[u]] = 1  # each window cell of the unit, once
            assert torch.equal(writes["x", u], want), (t0, u)
            want = torch.zeros_like(writes["h1", u])
            want[j_lo : j_lo + 16 * m_tiles(tile, u)] = 1  # h1 over whole m-tiles, once
            assert torch.equal(writes["h1", u], want), (t0, u)
    addrs = torch.cat([a.reshape(-1, 4, 8) for a in checks["row_addrs"]])
    assert (addrs % 16 == 0).all(), "an ldmatrix row address is not 16-byte aligned"
    groups = (addrs // 16) % 8
    distinct = (groups[..., :, None] == groups[..., None, :]).sum(-1)
    assert (distinct == 1).all(), "an ldmatrix phase has two rows in one bank group"


@pytest.mark.parametrize("c", sorted(PLANS))
def test_shared_memory_fits_the_blocks_per_sm(c):
    """mma_smem_bytes<C> and the blocks per SM it leaves (228 KB an SM, 1 KB
    reserved a block): 3 / 2 / 2 at C = 32 / 64 / 128; the recomputed halo,
    in whole m-tiles, at most 25% of the owned rows."""
    tile, kc, _, _ = PLANS[c]
    smem = (2 * plane_rows(c) * (c + APAD) + 2 * 3 * c * (kc + APAD)) * 2
    assert 233472 // (smem + 1024) == {32: 3, 64: 2, 128: 2}[c]
    computed = sum(16 * m_tiles(tile, u) for u in range(3))
    assert computed <= 1.25 * 3 * tile


def test_a_padded_row_stride_is_what_keeps_the_phases_conflict_free():
    """The same walk with the plane rows unpadded (stride C, 64-256 bytes)
    puts the 8 rows of an ldmatrix phase into one or two bank groups."""
    for c in PLANS:
        rows = torch.arange(8)
        assert len(set(((rows * (c + APAD) * 2 // 16) % 8).tolist())) == 8
        assert len(set(((rows * c * 2 // 16) % 8).tolist())) <= 4
