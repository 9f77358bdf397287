"""K2's float32 path, emulated on the CPU in float64.

``vibravox_tpu_torch/ops/csrc/fused_residual_bwd.cu`` runs the float32
residual stack backward in two kinds of work.  The recompute (x1 and x2 in
``unit_forward_fma_kernel``, each unit's h1 and h2 over a tile's window in
``unit_backward_tf32_kernel``) runs on FMAs and sums every output over input
channel, then tap, from 0, one ``fmaf`` a term: the plain convolutions'
order, so that leaky'(h2) takes the plain chain's sign where an h2 lies
within float32 rounding of zero.  The gradient products (dWp, dh1 = Wp^T
dh2, dWd, dx) run on ``mma.sync.aligned.m16n8k8`` in 3xTF32 (each operand
split into TF32 hi and lo, lo.hi + hi.lo + hi.hi into a fresh sum a k8
step, added to the accumulator in f32), A of the channel products from the
streamed weight chunks by ``ldmatrix.x4``, every other fragment one float a
register from channel-major float32 planes.  A CUDA kernel cannot run here,
so this file writes out the same arithmetic in torch: shared memory as flat
float32 cells (NaN until written) with the planes' row offsets, the weight
layout launch and the chunk ring, each warp's walk in the recompute and in
each product, the m16n8k8 maps and the TF32 split (from
``tests/test_torch_residual_tf32.py``), the reflect fold terms of dx, the
persistent grid's per-block partials and their block-order sum, and the
plans (``F32Plan<C>``, read from the source).

Held:
- the emulated stack backward to autograd of ``plain_residual_stack`` in
  float32 at K2's unchanged float32 bar (dx 1e-4, dW 2e-4 of scale);
- each emulated unit backward to the float64 backward of the same unit
  taken with the emulated recompute's own leaky' masks, at
  ``F32_ACCURACY`` (2e-6 of scale: float32 rounding of C-term sums, far
  below the bar, far above float64's);
- the recompute bit-equal to a plain ``fmaf`` chain in channel-then-tap
  order; every dx, plane, partial and output cell written exactly once a
  tile; every fragment load free of bank conflicts (a scalar load's 32
  lanes in 32 banks, an ``ldmatrix`` phase's 8 rows in 8 bank groups);
- each plan fitting the shared memory of its blocks per SM;
- one planted h2 within an ulp of zero: the FMA-order recompute keeps the
  plain chain's sign there and a 3xTF32 recompute flips it.
No JAX.
"""

import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from vibravox_tpu_torch.ops.fused_residual import plain_residual_stack_backward
from test_torch_residual_tf32 import A_COLS, A_ROWS, G, LANE, Q, Smem, assert_conflict_free, f32, mma_3xtf32
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

CSRC = Path(__file__).resolve().parents[1] / "vibravox_tpu_torch" / "ops" / "csrc"
WARPS = 8  # kThreads / 32
STAGES = 2  # kF32Stages: the weight ring's buffers
DILS = (1, 3, 9)
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024
SLOPE = 0.01
F32_ACCURACY = 2e-6  # of scale: a unit's products in 3xTF32 against float64 with the same masks
K2_TOL_DX, K2_TOL_DW = 1e-4, 2e-4  # chip_smoke.py's K2_TOL[float32], of scale
PLAN_KEYS = ("tile", "fwd_tile", "ki", "kc", "mt", "blocks")


def _plans():
    """F32Plan<C> of fused_residual_bwd.cu: {C: {key: value}}."""
    text = (CSRC / "fused_residual_bwd.cu").read_text()
    pat = re.compile(r"struct F32Plan<(\d+)> \{\s*static constexpr int kTile = (\d+), kFwdTile = (\d+), "
                     r"kKi = (\d+), kKc = (\d+), kMt = (\d+), kBlocks = (\d+);")
    plans = {int(m[1]): dict(zip(PLAN_KEYS, (int(v) for v in m.groups()[1:]))) for m in pat.finditer(text)}
    assert sorted(plans) == [32, 64, 128], plans
    return plans


PLANS = _plans()


# ---- float32 arithmetic -------------------------------------------------------

def fmaf(a, b, c):
    """fmaf on float32 values held in float64: the product is exact in
    float64, the sum rounds once to float32 (a float64 rounding first, which
    differs from fmaf only on exact float32 ties below float64's precision)."""
    return f32(a * b + c)


def reflect_clamped(t, t_len):
    t = t.abs()
    t = torch.where(t > t_len - 1, 2 * (t_len - 1) - t, t)
    return t.clamp(0, t_len - 1)


# ---- the planes ---------------------------------------------------------------

def plane_stride(cols):
    """plane_stride: the smallest S >= cols + 4 with S = 8 mod 16."""
    return (cols + 4 + 7) // 16 * 16 + 8


def plane_row(ch, stride):
    """plane_row: channel ch's first column, 4 floats further when bit 2 is set."""
    return ch * stride + (ch & 4)


class Geometry:
    """F32Geometry<C, D>, in floats."""

    def __init__(self, c, d):
        p = PLANS[c]
        self.c, self.d = c, d
        self.tile, self.fwd_tile = p["tile"], p["fwd_tile"]
        self.win = self.tile + 2 * d
        self.win_nt = -(-self.win // 8)
        self.sx = plane_stride(self.tile + 4 * d)
        self.sw = plane_stride(8 * self.win_nt)
        self.buf = max(3 * p["ki"] * c, c * (p["kc"] + 4))
        self.ring = STAGES * self.buf
        self.bwd_floats = c * (self.sx + 2 * self.sw) + self.ring
        self.fwd_sx, self.fwd_sh = plane_stride(self.fwd_tile + 2 * d), plane_stride(self.fwd_tile)
        self.fwd_floats = c * (self.fwd_sx + self.fwd_sh) + self.ring


def recompute_chunks(c):
    """h1's and h2's weight chunks, KI reduction rows each"""
    return 2 * (c // PLANS[c]["ki"])


def blocks_per_sm(smem_bytes):
    return SMEM_PER_SM // (smem_bytes + SMEM_RESERVED)


class Cells(Smem):
    """Shared memory with scalar loads checked for bank conflicts as they
    are made (unless ``banks`` is False): the 32 lanes of each load in 32
    distinct banks, or on one word."""

    def __init__(self, n_elems, banks=True):
        super().__init__(n_elems)
        self.banks = banks

    def lds(self, addr):
        if self.banks:
            key = ((addr % 32) << 40) + addr  # (bank, word), sorted: a bank's words must be one
            key = key.reshape(-1, 32).sort(-1).values
            same_bank = (key[:, 1:] >> 40) == (key[:, :-1] >> 40)
            assert not (same_bank & (key[:, 1:] != key[:, :-1])).any(), \
                "a scalar shared-memory load has a bank conflict"
        return self.cells[addr]


# ---- weights and the chunk ring ------------------------------------------------

def layout_weights(kernels):
    """layout_unit_weights_f32_kernel: wt[unit][slot][r][o], slot k < 3 =
    Wd[o, r, k], slot 3 = Wp[o, r]."""
    return torch.stack([torch.cat([wd.permute(2, 1, 0), wp.permute(2, 1, 0)]) for wd, wp in kernels])


class Stream:
    """F32Stream<C, kBackward> over one unit's slots wt_u (4, C, C): chunk m
    of the block's sequence into buffer m % STAGES, written when the kernel
    issues it (start, then each acquire refills the buffer every warp is
    done with), so a read of the wrong buffer or chunk shows."""

    def __init__(self, sm, base, c, wt_u, backward, m_end):
        p = PLANS[c]
        self.sm, self.base, self.c, self.wt = sm, base, c, wt_u
        self.ki, self.kc, self.stages = p["ki"], p["kc"], STAGES
        self.row_chunks, self.col_chunks = c // self.ki, c // self.kc
        self.recompute = 2 * self.row_chunks
        self.chunks = self.recompute + (4 * self.col_chunks if backward else 0)
        self.buf = max(3 * self.ki * c, c * (self.kc + 4))
        self.m, self.m_end = 0, m_end
        for m in range(self.stages - 1):
            self.issue(m)

    def issue(self, m):
        if m >= self.m_end:
            return
        n, c = m % self.chunks, self.c
        buf = self.base + (m % self.stages) * self.buf
        if n < self.row_chunks:
            for k in range(3):
                cells = buf + k * self.ki * c + torch.arange(self.ki * c)
                self.sm.cells[cells] = self.wt[k, n * self.ki : (n + 1) * self.ki].reshape(-1)
        elif n < self.recompute:
            r0 = (n - self.row_chunks) * self.ki
            self.sm.cells[buf + torch.arange(self.ki * c)] = self.wt[3, r0 : r0 + self.ki].reshape(-1)
        else:
            blk, slot = n - self.recompute, 3
            if blk >= self.col_chunks:
                blk -= self.col_chunks
                slot, blk = blk % 3, blk // 3
            cells = buf + torch.arange(c)[:, None] * (self.kc + 4) + torch.arange(self.kc)[None, :]
            self.sm.cells[cells] = self.wt[slot, :, blk * self.kc : (blk + 1) * self.kc]

    def acquire(self):
        self.issue(self.m + self.stages - 1)
        buf = self.base + (self.m % self.stages) * self.buf
        self.m += 1
        return buf


# ---- the recompute on FMAs -------------------------------------------------------

def fma_product(sm, stream, c, kt, step, n_pos, plane, sx, np_cols):
    """fma_product<C, KT, STEP, NP>: Y[o][p] = sum_r sum_k W_k[r][o] X[r][p + k STEP],
    one fmaf a term, r ascending then k; warp w owns output channels w C / 8
    on, lane l column l of each 32-column group.  Returns (o (8, MO), p (8,
    NP, 32), Y (8, MO, NP, 32)); columns p >= n_pos are computed from column
    n_pos - 1 and not stored."""
    ki, mo = PLANS[c]["ki"], c // WARPS
    warp = torch.arange(WARPS)
    o = (warp * mo)[:, None] + torch.arange(mo)[None, :]
    p = (32 * torch.arange(np_cols)[:, None] + LANE).expand(WARPS, -1, -1)
    col = p.clamp(max=n_pos - 1)
    acc = torch.zeros(WARPS, mo, np_cols, 32, dtype=torch.float64)
    for r0 in range(0, c, ki):
        w = stream.acquire()
        for ii in range(ki):
            r = r0 + ii
            for k in range(kt):
                xv = sm.lds(plane + plane_row(r, sx) + col + k * step)  # (8, NP, 32)
                w_at = w + (k * ki + ii) * c + o  # a warp's MO weights: MO / 4 aligned float4 broadcasts
                assert (w_at[:, ::4] % 4 == 0).all()
                acc = fmaf(sm.cells[w_at][:, :, None, None], xv[:, None], acc)
    return o, p, acc


def store_fma(o, p, acc, n_pos, fn):
    """The epilogue over the stored columns: fn(o, p, y) on flat tensors."""
    oo, pp = torch.broadcast_tensors(o[:, :, None, None], p[:, None])
    keep = pp < n_pos
    fn(oo[keep], pp[keep], acc[keep])


def fma_chain(w, xs):
    """The plain order as a reference: sum_r sum_k fmaf(w[o, r, k], xs[k][r, p]),
    r ascending then k, from 0.  w (O, R, K), xs: K tensors (R, P)."""
    acc = torch.zeros(w.shape[0], xs[0].shape[1], dtype=torch.float64)
    for r in range(w.shape[1]):
        for k in range(w.shape[2]):
            acc = fmaf(w[:, r, k][:, None], xs[k][r][None, :], acc)
    return acc


# ---- the products on 3xTF32 tensor cores ----------------------------------------

def tf32_step(a, b, acc):
    """one k8 step of 3xTF32 into a fresh sum, added to acc in f32"""
    return f32(acc + mma_3xtf32(a, b, torch.zeros_like(acc)))


def tc_channel_product(sm, stream, c, kt, nnt, plane, sp, col0, tap_step, mirror=None):
    """tc_channel_product<C, KT, NNT>: acc (8, MT, NT, 32, 4) and the live
    n-tiles (8, NT).  mirror(k, n) gives, per output column n (a tensor) of
    tap k, a second plane column added to B's value in f32 (-1: none)."""
    p_ = PLANS[c]
    kc, mt = p_["kc"], p_["mt"]
    wm_n = c // 16 // mt
    wn_n = WARPS // wm_n
    nt_n = -(-nnt // wn_n)
    warp = torch.arange(WARPS)
    m0 = (warp // wn_n) * mt * 16
    nt = (warp % wn_n)[:, None] + wn_n * torch.arange(nt_n)[None, :]
    live = nt < nnt
    a_r = (LANE & 7) + ((LANE >> 3) & 1) * 8
    a_c = (LANE >> 4) * 4
    acc = torch.zeros(WARPS, mt, nt_n, 32, 4, dtype=torch.float64)
    for k0 in range(0, c, kc):
        for k in range(kt):
            w = stream.acquire()
            c0 = col0 + k * tap_step + G
            for ks in range(0, kc, 8):
                rows = m0[:, None, None] + 16 * torch.arange(mt)[None, :, None] + a_r
                a = sm.ldmatrix_x4(w + rows * (kc + 4) + ks + a_c)  # (8, MT, 32, 4)
                ntl = torch.where(live, nt, torch.zeros_like(nt))[:, :, None]
                b0 = sm.lds(plane + plane_row(k0 + ks + Q, sp) + c0 + 8 * ntl)
                b1 = sm.lds(plane + plane_row(k0 + ks + Q + 4, sp) + c0 + 8 * ntl)
                if mirror is not None:
                    mc = mirror(k, (8 * ntl + G).expand_as(b0))
                    on = mc >= 0
                    mv0 = sm.cells[plane + plane_row(k0 + ks + Q, sp) + mc.clamp(min=0)]
                    mv1 = sm.cells[plane + plane_row(k0 + ks + Q + 4, sp) + mc.clamp(min=0)]
                    b0 = torch.where(on, f32(b0 + mv0), b0)
                    b1 = torch.where(on, f32(b1 + mv1), b1)
                b = torch.stack([b0, b1], -1)  # (8, NT, 32, 2)
                new = tf32_step(a[:, :, None].expand(-1, -1, nt_n, -1, -1),
                                b[:, None].expand(-1, mt, -1, -1, -1), acc)
                acc = torch.where(live[:, None, :, None, None], new, acc)
    return acc, m0, nt, live


def tc_pairs(c, acc, m0, nt, live):
    """for_each_tc_pair: flat (row, column, value) of every live accumulator"""
    mt = acc.shape[1]
    rows = (m0[:, None, None, None, None] + 16 * torch.arange(mt)[None, :, None, None, None]
            + torch.stack([G, G, G + 8, G + 8], 1)[None, None, None])
    cols = 8 * nt[:, None, :, None, None] + torch.stack([2 * Q, 2 * Q + 1, 2 * Q, 2 * Q + 1], 1)[None, None, None]
    keep = live[:, None, :, None, None].expand_as(acc)
    rows, cols = rows.expand_as(acc), cols.expand_as(acc)
    return rows[keep], cols[keep], acc[keep]


def tc_gram(sm, c, ksteps, a_plane, sa, col_a, b_plane, sb, col_b):
    """tc_gram<C, KSTEPS>: acc[o][i] (8, MG, NG, 32, 4) = sum_t A[o][col_a + t] B[i][col_b + t]."""
    mg = ng = c // 32
    warp = torch.arange(WARPS)
    o0 = (warp >> 2) * 16 * mg
    i0 = (warp & 3) * 8 * ng
    acc = torch.zeros(WARPS, mg, ng, 32, 4, dtype=torch.float64)
    a_rows = o0[:, None, None, None] + 16 * torch.arange(mg)[None, :, None, None] + A_ROWS  # (8, MG, 32, 4)
    b_rows = (i0[:, None, None, None] + 8 * torch.arange(ng)[None, :, None, None] + G[:, None]).expand(-1, -1, -1, 2)
    b_cols = torch.stack([Q, Q + 4], 1)
    for ks in range(ksteps):
        t = 8 * ks
        a = torch.stack([sm.lds(a_plane + plane_row(a_rows[..., r], sa) + col_a + t + A_COLS[:, r])
                         for r in range(4)], -1)
        b = torch.stack([sm.lds(b_plane + plane_row(b_rows[..., r], sb) + col_b + t + b_cols[:, r])
                         for r in range(2)], -1)
        acc = tf32_step(a[:, :, None].expand(-1, -1, ng, -1, -1), b[:, None].expand(-1, mg, -1, -1, -1), acc)
    rows = (o0[:, None, None, None, None] + 16 * torch.arange(mg)[None, :, None, None, None]
            + torch.stack([G, G, G + 8, G + 8], 1)).expand_as(acc)
    cols = (i0[:, None, None, None, None] + 8 * torch.arange(ng)[None, None, :, None, None]
            + torch.stack([2 * Q, 2 * Q + 1, 2 * Q, 2 * Q + 1], 1)).expand_as(acc)
    return rows.reshape(-1), cols.reshape(-1), acc.reshape(-1)


def store_gram(part, writes, slot, o, i, v, first):
    """store_gram_f32: written on the block's first tile, added to after"""
    part[slot, o, i] = v if first else f32(part[slot, o, i] + v)
    writes[slot].index_put_((o, i), torch.ones_like(o), accumulate=True)


def load_plane(sm, plane, stride, c, xb, cols, t_first):
    t_len = xb.shape[1]
    j = torch.arange(cols)
    ch = torch.arange(c)
    sm.cells[plane + plane_row(ch, stride)[:, None] + j[None, :]] = xb[:, reflect_clamped(t_first + j, t_len)]


# ---- the kernels ------------------------------------------------------------------

def unit_forward(x, wt_u, d, checks=None, banks=True):
    """unit_forward_fma_kernel<C, D> over every block: x (B, C, T) -> x + leaky(h2)."""
    bsz, c, t_len = x.shape
    gm = Geometry(c, d)
    tile = gm.fwd_tile
    np_cols = tile // 32
    y = torch.full_like(x, float("nan"))
    writes = torch.zeros(bsz, c, t_len, dtype=torch.long)
    for bi in range(bsz):
        for t0 in range(0, t_len, tile):
            sm = Cells(gm.fwd_floats, banks)
            xs, hs, ring = 0, c * gm.fwd_sx, c * (gm.fwd_sx + gm.fwd_sh)
            stream = Stream(sm, ring, c, wt_u, False, recompute_chunks(c))
            load_plane(sm, xs, gm.fwd_sx, c, x[bi], tile + 2 * d, t0 - d)
            o, p, h1 = fma_product(sm, stream, c, 3, d, tile, xs, gm.fwd_sx, np_cols)

            def put_h1(oo, pp, v):
                sm.cells[hs + plane_row(oo, gm.fwd_sh) + pp] = v

            store_fma(o, p, h1, tile, put_h1)
            o, p, h2 = fma_product(sm, stream, c, 1, 0, tile, hs, gm.fwd_sh, np_cols)

            def put_y(oo, pp, v):
                keep = t0 + pp < t_len
                oo, pp, v = oo[keep], pp[keep], v[keep]
                xv = sm.cells[xs + plane_row(oo, gm.fwd_sx) + pp + d]
                y[bi, oo, t0 + pp] = f32(xv + torch.where(v >= 0, v, f32(SLOPE * v)))
                writes[bi, oo, t0 + pp] += 1

            store_fma(o, p, h2, tile, put_y)
            if checks is not None:
                checks.setdefault("row_addrs", []).extend(sm.row_addrs)
    assert torch.equal(writes, torch.ones_like(writes)), "a forward output cell is not written exactly once"
    return y


def unit_backward(x, g, wt_u, d, blocks, checks, banks=True):
    """unit_backward_tf32_kernel<C, D> on a persistent grid of ``blocks``
    blocks, then reduce_partials_kernel: (dx, dwd (C, C, 3), dwp (C, C, 1)).
    checks["dh2"] collects (b, channel, time, h2, dh2) of every dh2 cell
    in [0, T) the walk wrote."""
    bsz, c, t_len = x.shape
    gm = Geometry(c, d)
    tile, win, sx, sw = gm.tile, gm.win, gm.sx, gm.sw
    np_cols = -(-win // 32)
    tiles_per_row = -(-t_len // tile)
    n_tiles = tiles_per_row * bsz
    dx = torch.full_like(x, float("nan"))
    dx_writes = torch.zeros(bsz, c, t_len, dtype=torch.long)
    partial = torch.full((blocks, 4, c, c), float("nan"), dtype=torch.float64)
    xs, ds, hs, ring = 0, c * sx, c * (sx + sw), c * (sx + 2 * sw)
    row_addrs = checks.setdefault("row_addrs", [])
    for blk in range(blocks):
        sm = Cells(gm.bwd_floats, banks)
        my_tiles = list(range(blk, n_tiles, blocks))
        stream = Stream(sm, ring, c, wt_u, True, len(my_tiles) * (recompute_chunks(c) + 4 * (c // PLANS[c]["kc"])))
        for n, tidx in enumerate(my_tiles):
            first = n == 0
            b, t0 = tidx // tiles_per_row, (tidx % tiles_per_row) * tile
            writes = torch.zeros(4, c, c, dtype=torch.long)
            load_plane(sm, xs, sx, c, x[b], tile + 4 * d, t0 - 2 * d)
            # h1 over the window, 0 outside [0, T)
            o, p, h1 = fma_product(sm, stream, c, 3, d, win, xs, sx, np_cols)
            h1_writes = torch.zeros(c, win, dtype=torch.long)

            def put_h1(oo, pp, v):
                t = t0 - d + pp
                sm.cells[hs + plane_row(oo, sw) + pp] = torch.where((t >= 0) & (t < t_len), v, torch.zeros_like(v))
                h1_writes.index_put_((oo, pp), torch.ones_like(oo), accumulate=True)

            store_fma(o, p, h1, win, put_h1)
            assert torch.equal(h1_writes, torch.ones_like(h1_writes)), "an h1 cell is not written exactly once"
            # h2 -> dh2 = G * leaky'(h2)
            o, p, h2 = fma_product(sm, stream, c, 1, 0, win, hs, sw, np_cols)

            def put_dh2(oo, pp, v):
                t = t0 - d + pp
                inside = (t >= 0) & (t < t_len)
                gv = torch.where(inside, g[b, oo, t.clamp(0, t_len - 1)], torch.zeros_like(v))
                cell = f32(gv * torch.where(v >= 0, torch.ones_like(v), torch.full_like(v, SLOPE)))
                sm.cells[ds + plane_row(oo, sw) + pp] = cell
                checks.setdefault("dh2", []).append((b, oo[inside], t[inside], v[inside], cell[inside]))

            store_fma(o, p, h2, win, put_dh2)
            # dWp over the owned rows
            oo, ii, v = tc_gram(sm, c, tile // 8, ds, sw, d, hs, sw, d)
            store_gram(partial[blk], writes, 3, oo, ii, v, first)
            # dh1 = Wp^T dh2 over the window's n8 tiles, into hs
            acc, m0, nt, live = tc_channel_product(sm, stream, c, 1, gm.win_nt, ds, sw, 0, 0)
            rows, cols, v = tc_pairs(c, acc, m0, nt, live)
            dh1_writes = torch.zeros(c, 8 * gm.win_nt, dtype=torch.long)
            dh1_writes.index_put_((rows, cols), torch.ones_like(rows), accumulate=True)
            assert torch.equal(dh1_writes, torch.ones_like(dh1_writes)), "a dh1 cell is not written exactly once"
            sm.cells[hs + plane_row(rows, sw) + cols] = v
            # dWd per tap
            for k in range(3):
                oo, ii, v = tc_gram(sm, c, tile // 8, hs, sw, d, xs, sx, (k + 1) * d)
                store_gram(partial[blk], writes, k, oo, ii, v, first)
            assert torch.equal(writes, torch.ones_like(writes)), "a partial cell is not written exactly once a tile"
            # dx at the owned rows, with the reflect fold terms in tap 0's and
            # tap 2's B on an edge tile
            edge = t0 <= d or t0 + tile >= t_len - 1 - d

            def mirror(k, p):
                s_ = t0 + p
                none = torch.full_like(p, -1)
                if not edge or k == 1:
                    return none
                if k == 0:
                    return torch.where((s_ >= 1) & (s_ <= d), 2 * d - s_ - t0, none)
                return torch.where((s_ >= t_len - 1 - d) & (s_ <= t_len - 2), 2 * (t_len - 1) - s_ - t0, none)

            acc, m0, nt, live = tc_channel_product(sm, stream, c, 3, tile // 8, hs, sw, 2 * d, -d, mirror)
            rows, cols, v = tc_pairs(c, acc, m0, nt, live)
            s = t0 + cols
            keep = s < t_len
            rows, s, v = rows[keep], s[keep], v[keep]
            dx[b, rows, s] = f32(g[b, rows, s] + v)
            dx_writes[b, rows, s] += 1
        row_addrs.extend(sm.row_addrs)
    assert torch.equal(dx_writes, torch.ones_like(dx_writes)), "a dx cell is not written exactly once"
    # reduce_partials_kernel: the blocks' partials summed in block order
    total = torch.zeros(4, c, c, dtype=torch.float64)
    for blk in range(blocks):
        total = f32(total + partial[blk])
    return dx, total[:3].permute(1, 2, 0), total[3][:, :, None]


def stack_backward(x, kernels, g, blocks=2, checks=None):
    """The float32 K2 call: the weight layout, x1 and x2 recomputed, units 2,
    1, 0 (bank conflicts are the walk tests' to check)."""
    checks = {} if checks is None else checks
    wt = layout_weights(kernels)
    x1 = unit_forward(x, wt[0], 1, checks, banks=False)
    x2 = unit_forward(x1, wt[1], 3, checks, banks=False)
    xin = (x, x1, x2)
    dws = [None] * 3
    gu = g
    for u in (2, 1, 0):
        gu, dwd, dwp = unit_backward(xin[u], gu, wt[u], DILS[u], blocks, checks, banks=False)
        dws[u] = (dwd, dwp)
    return gu, tuple(dws)


# ---- references ---------------------------------------------------------------------

def reflect_pad(x, d):
    return F.pad(x, (d, d), mode="reflect")


def chain_unit(x, wd, wp, d):
    """h1, h2 of a unit per batch row by the plain fmaf chain (input channel, then tap)."""
    h1s, h2s = [], []
    for xb in x:
        xp = reflect_pad(xb[None], d)[0]
        t_len = xb.shape[1]
        h1 = fma_chain(wd, [xp[:, k * d : k * d + t_len] for k in range(3)])
        h2 = fma_chain(wp, [h1])
        h1s.append(h1)
        h2s.append(h2)
    return torch.stack(h1s), torch.stack(h2s)


def masked_unit_backward(x, g, wd, wp, d, mask):
    """float64 backward of x + mask * (Wp . dilconv(x)) with the leaky' mask held fixed"""
    xr = x.detach().clone().requires_grad_(True)
    wdr, wpr = wd.detach().clone().requires_grad_(True), wp.detach().clone().requires_grad_(True)
    h2 = F.conv1d(F.conv1d(reflect_pad(xr, d), wdr, dilation=d), wpr)
    y = xr + mask * h2
    return torch.autograd.grad(y, [xr, wdr, wpr], g)


def rel_err(out, ref):
    return ((out - ref).abs().max() / ref.abs().max()).item()


def _inputs(b, c, t, seed):
    """float32 values in float64: x ~ 0.5 N(0, 1), weights as chip_smoke.py's, g ~ 0.1 N(0, 1)"""
    gen = torch.Generator().manual_seed(seed)
    scale = 0.5 / (3 * c) ** 0.5
    x = f32(torch.randn(b, c, t, generator=gen, dtype=torch.float64) * 0.5)
    ks = tuple((f32(torch.randn(c, c, 3, generator=gen, dtype=torch.float64) * scale),
                f32(torch.randn(c, c, 1, generator=gen, dtype=torch.float64) * scale)) for _ in range(3))
    g = f32(torch.randn(b, c, t, generator=gen, dtype=torch.float64) * 0.1)
    return x, ks, g


def _length(c, d, name):
    """short: the shortest T (10), or a T below one tile; ragged: two tiles and
    a ragged third one"""
    if name == "short":
        return 10 if d == 9 else 40
    return 2 * PLANS[c]["tile"] + 37


# ---- tests ----------------------------------------------------------------------------

@pytest.mark.parametrize("c", (32, 64, 128))
def test_plans_fit_their_blocks_per_sm(c):
    """Each kernel's shared memory leaves the blocks per SM its launch bounds
    promise (a thread may then take 65536 / (256 x blocks) registers); the
    owned rows are whole k8 steps, the forward tile whole 32-row columns,
    each warp's recompute channels whole float4s, the warps share the
    m-tiles evenly and the chunks divide C; both fragment shapes meet no bank conflict in any plane."""
    p = PLANS[c]
    for d in DILS:
        gm = Geometry(c, d)
        assert blocks_per_sm(4 * gm.bwd_floats) >= p["blocks"], (d, 4 * gm.bwd_floats)
        if d < 9:
            assert blocks_per_sm(4 * gm.fwd_floats) >= 1
        for stride, cols in ((gm.sx, gm.tile + 4 * d), (gm.sw, 8 * gm.win_nt)):
            assert stride % 16 == 8 and stride >= cols + 4
            for col in range(32):
                sm = Cells(c * stride + 64)
                g8 = (LANE >> 2)[None, :] + 8 * torch.arange(c // 8)[:, None]
                sm.lds(plane_row(g8, stride) + col + (LANE & 3))  # 8 channels x 4 columns
                q4 = (LANE & 3)[None, :] + 8 * torch.arange(c // 8)[:, None]
                sm.lds(plane_row(q4, stride) + col + (LANE >> 2))  # 4 channels x 8 columns
                sm.lds(plane_row(q4 + 4, stride) + col + (LANE >> 2))
    assert 65536 // (256 * p["blocks"]) >= 128
    assert p["tile"] % 8 == 0 and p["fwd_tile"] % 32 == 0
    assert c % p["ki"] == 0 and c % p["kc"] == 0 and p["kc"] % 8 == 0 and (c // WARPS) % 4 == 0
    assert 16 * p["mt"] * (c // 16 // p["mt"]) == c and WARPS % (c // 16 // p["mt"]) == 0


@pytest.mark.parametrize("c", (32, 64, 128))
def test_weight_layout_and_chunk_stream(c):
    """The laid-out slots are Wd's taps and Wp as [r][o]; the ring hands each
    chunk of a backward tile, twice over, to the product that takes it."""
    _, ks, _ = _inputs(1, c, 10, seed=c)
    wt = layout_weights(ks)
    for u, (wd, wp) in enumerate(ks):
        for k in range(3):
            assert torch.equal(wt[u, k], wd[:, :, k].T)
        assert torch.equal(wt[u, 3], wp[:, :, 0].T)
    p = PLANS[c]
    gm = Geometry(c, 9)
    sm = Cells(gm.ring)
    rows, kp = c // p["ki"], p["ki"]
    chunks = recompute_chunks(c) + 4 * (c // p["kc"])
    stream = Stream(sm, 0, c, wt[1], True, 2 * chunks)
    for m in range(2 * chunks):
        buf = stream.acquire()
        n = m % chunks
        if n < rows:
            for k in range(3):
                got = sm.cells[buf + k * p["ki"] * c + torch.arange(p["ki"] * c)].view(p["ki"], c)
                assert torch.equal(got, wt[1, k, n * p["ki"] : (n + 1) * p["ki"]])
        elif n < recompute_chunks(c):
            r0 = (n - rows) * kp
            assert torch.equal(sm.cells[buf + torch.arange(kp * c)].view(kp, c), wt[1, 3, r0 : r0 + kp])
        else:
            blk = n - recompute_chunks(c)
            slot = 3 if blk < c // p["kc"] else (blk - c // p["kc"]) % 3
            c0 = (blk if blk < c // p["kc"] else (blk - c // p["kc"]) // 3) * p["kc"]
            got = sm.cells[buf + torch.arange(c)[:, None] * (p["kc"] + 4) + torch.arange(p["kc"])[None, :]]
            assert torch.equal(got, wt[1, slot, :, c0 : c0 + p["kc"]])


@pytest.mark.parametrize("c,d", [(c, d) for c in (32, 64, 128) for d in (1, 3)])
def test_unit_forward_is_the_fma_chain(c, d):
    """The forward recompute equals x + leaky(h2) from the plain fmaf chain
    bit for bit, over two tiles and a ragged third, and float64 within
    float32 accuracy."""
    t = 2 * PLANS[c]["fwd_tile"] + 19
    x, ks, _ = _inputs(1, c, t, seed=c + d)
    wd, wp = ks[0]
    y = unit_forward(x, layout_weights(ks)[0], d)
    _, h2 = chain_unit(x, wd, wp, d)
    assert torch.equal(y, f32(x + torch.where(h2 >= 0, h2, f32(SLOPE * h2))))
    h64 = F.conv1d(F.conv1d(reflect_pad(x, d), wd, dilation=d), wp)
    assert rel_err(y, x + F.leaky_relu(h64, SLOPE)) <= F32_ACCURACY


UNIT_CASES = [(c, d, n) for c in (32, 64, 128) for d in DILS for n in ("short", "ragged")]


@pytest.mark.parametrize("c,d,name", UNIT_CASES, ids=[f"c{c}-d{d}-{n}" for c, d, n in UNIT_CASES])
def test_unit_backward_walk(c, d, name):
    """One unit's backward over a persistent grid of two blocks (three when
    T is ragged): every h2 the walk recomputes is the plain fmaf chain's and
    every dh2 G times its leaky', bit for bit; dx and dW match the float64
    backward taken with those masks at F32_ACCURACY; every cell is written
    once and no fragment load meets a bank conflict."""
    t = _length(c, d, name)
    b = 2 if name == "short" else 1
    x, ks, g = _inputs(b, c, t, seed=7 * c + d + t)
    wd, wp = ks[2]
    checks = {}
    dx, dwd, dwp = unit_backward(x, g, layout_weights(ks)[2], d, 2 if name == "short" else 3, checks)
    _, h2 = chain_unit(x, wd, wp, d)
    mask = torch.where(h2 >= 0, torch.ones_like(h2), torch.full_like(h2, SLOPE))
    want = f32(g * mask)
    for bi, ch, tt, v, dh2 in checks["dh2"]:
        assert torch.equal(v, h2[bi, ch, tt]) and torch.equal(dh2, want[bi, ch, tt])
    rdx, rwd, rwp = masked_unit_backward(x, g, wd, wp, d, mask)
    assert torch.isfinite(dx).all() and torch.isfinite(dwd).all() and torch.isfinite(dwp).all()
    assert rel_err(dx, rdx) <= F32_ACCURACY
    assert rel_err(dwd, rwd) <= F32_ACCURACY and rel_err(dwp, rwp) <= F32_ACCURACY
    assert_conflict_free(checks["row_addrs"])


STACK_CASES = [(c, n) for c in (32, 64, 128) for n in ("short", "ragged")]


@pytest.mark.parametrize("c,name", STACK_CASES, ids=[f"c{c}-{n}" for c, n in STACK_CASES])
def test_stack_backward_meets_the_f32_bar(c, name):
    """The emulated float32 K2 call against autograd of plain_residual_stack
    in float32, at K2's unchanged float32 bar."""
    t = _length(c, 9, name)
    x, ks, g = _inputs(2 if name == "short" else 1, c, t, seed=11 * c + t)
    dx, dws = stack_backward(x, ks, g)
    ref_dx, ref_dws = plain_residual_stack_backward(
        x.float(), tuple((wd.float(), wp.float()) for wd, wp in ks), g.float())
    assert rel_err(dx, ref_dx.double()) <= K2_TOL_DX
    for pair, ref_pair in zip(dws, ref_dws):
        for dw, ref in zip(pair, ref_pair):
            assert rel_err(dw, ref.double()) <= K2_TOL_DW


def _tf32_dot(w, v):
    """w . v as a 3xTF32 product would sum it: k8 steps on m16n8k8 tiles,
    each into a fresh sum added to the accumulator in f32"""
    acc = torch.zeros(32, 4, dtype=torch.float64)
    for k0 in range(0, w.numel(), 8):
        a = w[k0 + A_COLS].expand(32, 4)  # every row of A is w
        b = v[k0 + torch.stack([Q, Q + 4], 1)]  # every column of B is v
        acc = tf32_step(a, b, acc)
    return acc[0, 0]


def test_fma_order_keeps_the_sign_where_3xtf32_flips():
    """A planted h2 within one float32 ulp (of its largest term) of zero:
    the kernel's h2 walk (fma_product over an h1 plane, Wp from the ring)
    gives it the plain fmaf chain's sign, bit for bit, while the same sum in
    3xTF32 comes out with the other sign; so a tensor-core recompute would
    flip leaky' there and move dx by ~G."""
    c, d = 32, 1
    gen = torch.Generator().manual_seed(0)
    for _ in range(500):
        w = f32(torch.randn(c, generator=gen, dtype=torch.float64) * 0.1)
        v = f32(torch.randn(c, generator=gen, dtype=torch.float64))
        v[-1] = f32(-(w[:-1] * v[:-1]).sum() / w[-1])  # the exact sum cancels to about an ulp
        chain = fma_chain(w[None, :, None], [v[:, None]])[0, 0]
        tc = _tf32_dot(w, v)
        ulp = 2.0 ** (torch.frexp((w * v).abs().max())[1].item() - 24)
        if chain != 0 and tc != 0 and (chain > 0) != (tc > 0) and abs(chain) <= ulp:
            break
    else:
        pytest.fail("no planted near-zero h2 found")
    # the kernel's walk: window column 5 holds v, the others random; every
    # output channel's Wp row is w
    gm = Geometry(c, d)
    sm = Cells(gm.bwd_floats)
    hs, ring = c * (gm.sx + gm.sw), c * (gm.sx + 2 * gm.sw)
    h1 = f32(torch.randn(c, gm.win, generator=gen, dtype=torch.float64))
    h1[:, 5] = v
    sm.cells[hs + plane_row(torch.arange(c), gm.sw)[:, None] + torch.arange(gm.win)[None, :]] = h1
    wp = w[None, :, None].expand(c, c, 1)
    wt = layout_weights([(torch.zeros(c, c, 3, dtype=torch.float64), wp)] * 3)[0]
    stream = Stream(sm, ring, c, wt, True, 10 ** 6)
    for _ in range(c // PLANS[c]["ki"]):  # the h1 chunks, consumed
        stream.acquire()
    o, p, h2 = fma_product(sm, stream, c, 1, 0, gm.win, hs, gm.sw, -(-gm.win // 32))
    got = torch.full((c, gm.win), float("nan"), dtype=torch.float64)

    def put(oo, pp, val):
        got[oo, pp] = val

    store_fma(o, p, h2, gm.win, put)
    assert torch.equal(got, fma_chain(wp, [h1]))
    assert ((got[:, 5] > 0) == (chain > 0)).all() and ((got[:, 5] > 0) != (tc > 0)).all()
