"""K1's float32 tensor-core path in 3xTF32, emulated on the CPU in float64.

``vibravox_tpu_torch/ops/csrc/fused_residual.cu`` runs the float32 residual
stack forward (``residual_stack_mma_kernel<float, C, V>``) on
``mma.sync.aligned.m16n8k8`` with TF32 operands, fragments loaded by
``ldmatrix.x4`` from time-major float32 planes ``[row][C + 4]``, and every
operand split into TF32 hi and lo parts whose products lo.hi + hi.lo + hi.hi
are summed (common.cuh).  A CUDA kernel cannot run here, so this file writes
out the same arithmetic in torch: shared memory as flat float32 cells (NaN
until written) with the planes' padded row stride, the ``ldmatrix`` lane
maps on 32-bit data, the m16n8k8 TF32 fragment maps, TF32 rounding (to
nearest, ties away, to 10 mantissa bits: ``cvt.rna.tf32.f32``, which the
kernel computes in its integer form) in float64,
a fresh f32 sum a step (rounded after every ``mma``) added to the
accumulator in f32, the weight relayout and
chunk stream, each warp's tile walk per unit, the reflect refill by rows,
and both of the kernel's plans per C (``MmaPlan<float, C, V>``, read from
the source).

The emulated kernel is held to ``plain_residual_stack`` at 2e-5 of scale
(K1's float32 bar), every output cell is written exactly once, every
``ldmatrix`` row address is 16-byte aligned and the 8 rows of each phase fall
in 8 distinct 16-byte bank groups.  A single TF32 pass misses the bar at
C = 128, so the split is what carries the accuracy.  No JAX.
"""

import re
from pathlib import Path

import pytest
import torch

from vibravox_tpu_torch.ops.fused_residual import plain_residual_stack
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

CSRC = Path(__file__).resolve().parents[1] / "vibravox_tpu_torch" / "ops" / "csrc"
WARPS = 8  # K1's kThreads / 32
HALO = 13  # kHalo: 1 + 3 + 9
E = 4  # vec<float>(): floats in 16 bytes, the pad of every f32 plane and weight row
DILS, HALOS = (1, 3, 9), (12, 9, 0)  # dil_of(u), halo_of(u)
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024
SMS = 132  # the H100's SMs, for the plan variant the launcher picks


def _k1_plans():
    """MmaPlan<float, C, V> of fused_residual.cu: {(C, V): (TILE, KC, MW, NW, BLOCKS)}."""
    text = (CSRC / "fused_residual.cu").read_text()
    pat = re.compile(r"struct MmaPlan<float, (\d+), (\d+)> \{\s*static constexpr int kTile = (\d+), "
                     r"kKc = (\d+), kMw = (\d+), kNw = (\d+), kBlocks = (\d+);")
    plans = {(int(m[1]), int(m[2])): tuple(int(v) for v in m.groups()[2:]) for m in pat.finditer(text)}
    assert sorted(plans) == [(c, v) for c in (32, 64, 128) for v in (0, 1)], plans
    return plans


K1_PLANS = _k1_plans()

LANE = torch.arange(32)
G, Q = LANE >> 2, LANE & 3


# ---- TF32 and the 3xTF32 split ---------------------------------------------

def f32(v):
    """v rounded to float32 (the kernel's planes and accumulators)."""
    return v.to(torch.float32).to(torch.float64)


def tf32(v):
    """v (float64 holding float32 values) rounded to TF32 as cvt.rna does:
    to nearest with ties away from zero, keeping 10 mantissa bits."""
    m, e = torch.frexp(v)  # |m| in [0.5, 1): 11 significant bits are m * 2^11 rounded
    r = torch.sign(m) * torch.floor(m.abs() * 2048 + 0.5) / 2048
    return torch.ldexp(r, e)


def split(v):
    """(hi, lo) = (tf32(v), tf32(v - hi)); v - hi is exact in float32."""
    hi = tf32(v)
    return hi, tf32(v - hi)


# ---- the fragment maps of m16n8k8 with TF32 operands (PTX ISA) -------------

A_ROWS, A_COLS = torch.stack([G, G + 8, G, G + 8], 1), torch.stack([Q, Q, Q + 4, Q + 4], 1)  # 16 x 8
B_K, B_N = torch.stack([Q, Q + 4], 1), torch.stack([G, G], 1)  # 8 x 8
C_ROWS, C_COLS = torch.stack([G, G, G + 8, G + 8], 1), torch.stack([2 * Q, 2 * Q + 1, 2 * Q, 2 * Q + 1], 1)


def _inverse(rows, cols, width):
    """For each cell of the matrix, the flat (lane, register) index holding it."""
    cell = (rows * width + cols).reshape(-1)
    inv = torch.full((int(cell.max()) + 1,), -1, dtype=torch.long)
    inv[cell] = torch.arange(cell.numel())
    assert (inv >= 0).all() and torch.equal(torch.sort(cell).values, torch.arange(cell.numel()))
    return inv


A_INV, B_INV, C_INV = _inverse(A_ROWS, A_COLS, 8), _inverse(B_K, B_N, 8), _inverse(C_ROWS, C_COLS, 8)
C_FLAT = (C_ROWS * 8 + C_COLS).reshape(-1)


def mma_tf32(a, b, c):
    """One m16n8k8 step on lane fragments a (..., 32, 4), b (..., 32, 2), c
    (..., 32, 4): C + A B from the maps, rounded to the f32 accumulator."""
    am = a.reshape(*a.shape[:-2], 128)[..., A_INV].reshape(*a.shape[:-2], 16, 8)
    bm = b.reshape(*b.shape[:-2], 64)[..., B_INV].reshape(*b.shape[:-2], 8, 8)
    cm = c.reshape(*c.shape[:-2], 128)[..., C_INV].reshape(*c.shape[:-2], 16, 8)
    out = f32(cm + am @ bm).reshape(*c.shape[:-2], 128)
    return out[..., C_FLAT].reshape(c.shape)


def mma_3xtf32(a, b, c, passes=3):
    """common.cuh's mma_3xtf32 on f32 fragments: lo.hi, hi.lo, then hi.hi
    into one accumulator; passes=1 is a single TF32 product hi.hi."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 3:
        c = mma_tf32(ah, bl, mma_tf32(al, bh, c))
    return mma_tf32(ah, bh, c)


# ---- shared memory and ldmatrix on 32-bit data -------------------------------

class Smem:
    """Flat shared memory of float32 cells (held in float64, NaN until
    written), with the byte address of every ldmatrix row recorded."""

    def __init__(self, n_elems):
        self.cells = torch.full((n_elems,), float("nan"), dtype=torch.float64)
        self.row_addrs = []  # (..., 4 phases, 8 rows) byte addresses

    def ldmatrix_x4(self, elem):
        """elem (..., 32): each lane's row address in floats.  Lane l gives
        row l % 8 of matrix l / 8 (8 rows of 16 bytes); register r of lane
        4 g + q receives word q of row g of matrix r.  Returns (..., 32, 4)."""
        self.row_addrs.append((4 * elem).reshape(*elem.shape[:-1], 4, 8))
        src = elem[..., 8 * torch.arange(4)[None, :] + G[:, None]]  # (..., lane, r): row of matrix r
        return self.cells[src + Q[:, None]]


def a_lane_offsets():
    """(row, column) each lane addresses for an A m16 x k8 tile: matrices
    (rows 0-7 | 8-15) x (k 0-3 | 4-7) as a0..a3."""
    return (LANE & 7) + ((LANE >> 3) & 1) * 8, (LANE >> 4) * E


def b_lane_offsets():
    """(weight row, column) each lane addresses for a pair of n8 tiles:
    matrices (n-tile 0 | 1) x (k 0-3 | 4-7), so registers b0, b1 of the
    first n-tile, then of the second."""
    return (LANE & 7) + (LANE >> 4) * 8, ((LANE >> 3) & 1) * E


def assert_conflict_free(row_addrs):
    addrs = torch.cat([a.reshape(-1, 4, 8) for a in row_addrs])
    assert (addrs % 16 == 0).all(), "an ldmatrix row address is not 16-byte aligned"
    groups = (addrs // 16) % 8
    assert ((groups[..., :, None] == groups[..., None, :]).sum(-1) == 1).all(), \
        "an ldmatrix phase has two rows in one bank group"


def reflect(g, t_len):
    g = g.abs()
    return torch.where(g > t_len - 1, 2 * (t_len - 1) - g, g)


# ---- K1: the kernel's walk -------------------------------------------------

def m_tiles(tile, u):
    return (tile + 2 * HALOS[u] + 15) // 16


def plane_rows(tile):
    """mma_rows(TILE): every row a unit's m-tiles read."""
    return max([tile + 2 * HALO] + [HALO - HALOS[u] + 16 * m_tiles(tile, u) + DILS[u] for u in range(3)])


def k1_smem_bytes(c, v):
    tile, kc = K1_PLANS[c, v][:2]
    return (2 * plane_rows(tile) * (c + E) + 2 * 3 * c * (kc + E)) * 4


def k1_variant(b, c, t):
    """pick_variant<float, C>: the second tile where the first gives fewer
    blocks than the card has SMs."""
    tile = K1_PLANS[c, 0][0]
    return 1 if b * -(-t // tile) < SMS else 0


def relayout(kernels):
    """relayout_weights_kernel: wt[unit][tap][o][i], taps 0-2 from wd and
    tap 3 from wp."""
    return torch.stack([torch.cat([wd.permute(2, 0, 1), wp.permute(2, 0, 1)]) for wd, wp in kernels])


def k1_tile(xb, wt, t0, plan, slope, passes, writes):
    """One block of residual_stack_mma_kernel<float, C, V>: batch row xb
    (C, T) at tile start t0.  Returns the stored tile (C, n) and the block's
    shared memory; adds one to writes["x", u][row, channel] per xs cell unit
    u writes and to writes["h1", u] per hs cell."""
    c, t_len = xb.shape
    tile, kc, mw, nw, _ = plan
    s = c + E
    rows = plane_rows(tile)
    wb = 3 * c * (kc + E)
    cpc = c // kc
    n_groups = c // (8 * nw)
    m_warps = WARPS // n_groups
    assert WARPS % n_groups == 0 and m_tiles(tile, 0) <= m_warps * mw and kc % (2 * E) == 0
    sm = Smem(2 * rows * s + 2 * wb)
    xs, hs, wbuf = 0, rows * s, 2 * rows * s
    g0 = t0 - HALO
    ch = torch.arange(c)

    # the load: (channel pair, row) per thread, transposed to time-major
    j = torch.arange(tile + 2 * HALO)
    g = reflect(g0 + j, t_len).clamp(0, t_len - 1)
    sm.cells[xs + j[:, None] * s + ch[None, :]] = xb[:, g].T

    def issue(n):
        """chunk n of the weight stream: unit n // (2 cpc), dilated then
        pointwise, into buffer n % 2 ([tap][o][KC + 4])"""
        u, r = divmod(n, 2 * cpc)
        point = r >= cpc
        i0 = (r - cpc if point else r) * kc
        buf = wbuf + (n & 1) * wb
        rr = torch.arange(c)[:, None] * (kc + E) + torch.arange(kc)[None, :]
        for slot, tap in enumerate([3] if point else [0, 1, 2]):
            sm.cells[buf + slot * c * (kc + E) + rr] = wt[u, tap, :, i0 : i0 + kc]
        return buf

    warp = torch.arange(WARPS)
    n0 = (warp // m_warps) * nw * 8
    mt0 = (warp % m_warps) * mw
    a_r, a_c = a_lane_offsets()
    b_r, b_c = b_lane_offsets()

    def product_step(acc, plane, a_row0, a_col, w, b_col, n_mt):
        """acc (warp, MW, NW, 32, 4) += A . B over one k8 step."""
        p = torch.arange(nw // 2)
        b_rows = n0[:, None, None] + 16 * p[None, :, None] + b_r  # (warp, pair, lane)
        b = sm.ldmatrix_x4(w + b_rows * (kc + E) + b_col + b_c)  # (warp, pair, 32, 4)
        b = b.reshape(WARPS, nw // 2, 32, 2, 2).transpose(2, 3).reshape(WARPS, nw, 32, 2)
        mt = mt0[:, None] + torch.arange(mw)[None, :]
        live = mt < n_mt  # warp-uniform
        a_rows = a_row0 + 16 * mt[..., None] + a_r
        assert a_rows[live].min() >= 0 and a_rows[live].max() < rows, "A reads outside its plane"
        a_rows = torch.where(live[..., None], a_rows, torch.zeros((), dtype=torch.long))
        a = sm.ldmatrix_x4(plane + a_rows * s + a_col + a_c)  # (warp, MW, 32, 4)
        if not live.all():
            sm.row_addrs[-1] = sm.row_addrs[-1][live]
        # a fresh sum a step (the kernel's d), added to the accumulator in f32
        d = mma_3xtf32(a[:, :, None].expand(-1, -1, nw, -1, -1), b[:, None].expand(-1, mw, -1, -1, -1),
                       torch.zeros_like(acc), passes)
        return torch.where(live[:, :, None, None, None], f32(acc + d), acc)

    n = 0
    for u in range(3):
        d, h = DILS[u], HALOS[u]
        j_lo, r_win = HALO - h, tile + 2 * h
        n_mt = m_tiles(tile, u)
        mt = mt0[:, None] + torch.arange(mw)[None, :]
        live = (mt < n_mt)[:, :, None, None, None].expand(-1, -1, nw, 32, 4)
        row_g = (j_lo + 16 * mt[:, :, None, None, None] + C_ROWS).expand_as(live)
        col_o = (n0[:, None, None, None, None] + 8 * torch.arange(nw)[None, None, :, None, None]
                 + C_COLS).expand_as(live)

        acc = torch.zeros(WARPS, mw, nw, 32, 4, dtype=torch.float64)
        for kci in range(cpc):
            buf = issue(n)
            n += 1
            for k in range(3):
                for ks in range(0, kc, 2 * E):
                    acc = product_step(acc, xs, j_lo + (k - 1) * d, kci * kc + ks, buf + k * c * (kc + E), ks, n_mt)
        cells = hs + row_g[live] * s + col_o[live]
        sm.cells[cells] = acc[live]  # h1 stays float32
        writes["h1", u].view(-1).index_put_((row_g[live] * c + col_o[live],), torch.ones_like(cells),
                                            accumulate=True)

        acc = torch.zeros_like(acc)
        for kci in range(cpc):
            buf = issue(n)
            n += 1
            for ks in range(0, kc, 2 * E):
                acc = product_step(acc, hs, j_lo, kci * kc + ks, buf, ks, n_mt)
        keep = live & (row_g < j_lo + r_win)
        cells = xs + row_g[keep] * s + col_o[keep]
        v = acc[keep]
        sm.cells[cells] = f32(sm.cells[cells] + torch.where(v >= 0, v, f32(slope * v)))
        writes["x", u].view(-1).index_put_((row_g[keep] * c + col_o[keep],), torch.ones_like(cells),
                                           accumulate=True)

        # the reflect refill by whole rows
        if u < 2 and (t0 - h < 0 or t0 + tile + h > t_len):
            lo, hi = max(0, t0 - h), min(t_len - 1, t0 + tile + h - 1)
            jj = torch.arange(j_lo, j_lo + r_win)
            gt = g0 + jj
            out = (gt < 0) | (gt >= t_len)
            src = reflect(gt[out], t_len).clamp(lo, hi) - g0
            sm.cells[xs + jj[out][:, None] * s + ch] = sm.cells[xs + src[:, None] * s + ch]

    n_own = min(tile, t_len - t0)
    jo = HALO + torch.arange(n_own)
    return sm.cells[xs + jo[None, :] * s + ch[:, None]], sm


def k1_stack(x, kernels, slope=0.01, passes=3, variant=None, checks=None):
    """The f32 kernel's result for x (B, C, T) and torch-layout kernels
    (float64 tensors of float32 values)."""
    b, c, t_len = x.shape
    v = k1_variant(b, c, t_len) if variant is None else variant
    plan = K1_PLANS[c, v]
    tile = plan[0]
    wt = relayout(kernels)
    y = torch.full_like(x, float("nan"))
    y_writes = torch.zeros(b, c, t_len, dtype=torch.long)
    rows = plane_rows(tile)
    for bi in range(b):
        for t0 in range(0, t_len, tile):
            writes = {(k, u): torch.zeros(rows, c, dtype=torch.long) for k in ("x", "h1") for u in range(3)}
            out, sm = k1_tile(x[bi], wt, t0, plan, slope, passes, writes)
            y[bi, :, t0 : t0 + out.shape[1]] = out
            y_writes[bi, :, t0 : t0 + out.shape[1]] += 1
            if checks is not None:
                checks.setdefault("tiles", []).append((t0, writes))
                checks.setdefault("row_addrs", []).extend(sm.row_addrs)
    if checks is not None:
        checks["y_writes"] = y_writes
    return y


def _inputs(b, c, t, seed):
    """float32 values in float64: x ~ 0.5 N(0, 1), weights as chip_smoke.py's."""
    gen = torch.Generator().manual_seed(seed)
    scale = 0.5 / (3 * c) ** 0.5
    x = f32(torch.randn(b, c, t, generator=gen, dtype=torch.float64) * 0.5)
    ks = tuple((f32(torch.randn(c, c, 3, generator=gen, dtype=torch.float64) * scale),
                f32(torch.randn(c, c, 1, generator=gen, dtype=torch.float64) * scale)) for _ in range(3))
    return x, ks


def rel_err(out, ref):
    return ((out - ref).abs().max() / ref.abs().max()).item()


K1_TOL = 2e-5  # chip_smoke.py's TOL[float32]: K1's float32 bar, of scale


# ---- tests --------------------------------------------------------------

def test_tf32_rounding_is_cvt_rna():
    """The float64 rounding equals the kernel's tf32_rna, cvt.rna.tf32.f32's
    bit rule on float32 values ((bits + 0x1000) & ~0x1fff for finite
    values): ties go away from zero, and v - hi is exact, so hi + lo
    carries 21 of v's 24 bits."""
    gen = torch.Generator().manual_seed(0)
    v32 = torch.randn(4096, generator=gen) * torch.logspace(-6, 6, 4096)
    ties = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 2 ** -11 * 3, 1 - 2 ** -12],
                        dtype=torch.float32)
    v32 = torch.cat([v32, ties])
    bits = ((v32.view(torch.int32).to(torch.int64) + 0x1000) & ~0x1FFF).to(torch.int32)
    want = bits.view(torch.float32).double()
    v = v32.double()
    assert torch.equal(tf32(v), want)
    assert tf32(torch.tensor([1 + 2 ** -11], dtype=torch.float64)).item() == 1 + 2 ** -10  # a tie, away
    hi, lo = split(v)
    assert torch.equal(f32(v - hi), v - hi) and torch.equal(tf32(lo), lo)
    assert ((v - hi - lo).abs() <= v.abs() * 2 ** -21).all()


def test_fragment_maps_and_ldmatrix_give_the_product():
    """The m16n8k8 maps cover each cell once; ldmatrix.x4 on a 32-bit plane
    with the kernel's lane offsets hands each lane its A registers (g, q),
    (g+8, q), (g, q+4), (g+8, q+4) and, from weights staged [n][k], its B
    registers (q, g), (q+4, g); one step is the matrix product."""
    gen = torch.Generator().manual_seed(1)
    rows, c = 40, 32
    s = c + E
    plane = f32(torch.randn(rows, c, generator=gen, dtype=torch.float64))
    w = f32(torch.randn(16, 8, generator=gen, dtype=torch.float64))  # [n][k]: two n-tiles
    sm = Smem(rows * s + 16 * (8 + E))
    sm.cells[torch.arange(rows)[:, None] * s + torch.arange(c)] = plane
    wbase = rows * s
    sm.cells[wbase + torch.arange(16)[:, None] * (8 + E) + torch.arange(8)] = w
    a_r, a_c = a_lane_offsets()
    b_r, b_c = b_lane_offsets()
    row0, col0 = 5, 8
    a = sm.ldmatrix_x4(row0 * s + (a_r * s + a_c) + col0)
    b = sm.ldmatrix_x4(wbase + b_r * (8 + E) + b_c)
    assert torch.equal(a, plane[row0 + A_ROWS, col0 + A_COLS])
    b = b.reshape(32, 2, 2).transpose(0, 1)  # (n-tile, lane, b0/b1)
    for nt in range(2):
        assert torch.equal(b[nt], w[8 * nt + B_N, B_K])
        out = mma_tf32(tf32(a), tf32(b[nt]), torch.zeros(32, 4, dtype=torch.float64))
        ref = tf32(plane[row0 : row0 + 16, col0 : col0 + 8]) @ tf32(w[8 * nt : 8 * nt + 8]).T
        assert torch.allclose(out, ref[C_ROWS, C_COLS], rtol=1e-6, atol=0)
    assert_conflict_free(sm.row_addrs)


K1_CASES = [(c, v, name) for c in (32, 64, 128) for v in (0, 1) for name in ("ragged", "short")]


def _k1_shape(c, v, name):
    """(B, T): three tiles of plan v with a ragged last one, or the shortest
    T (10) and a short one.  The launcher picks the plan from B and T; the
    emulation forces it, as every block of either plan is correct alone."""
    if name == "short":
        return (2, 10) if c == 32 else (1, 40)
    return 1, 2 * K1_PLANS[c, v][0] + 37


@pytest.mark.parametrize("c,v,name", K1_CASES, ids=[f"c{c}-plan{v}-{n}" for c, v, n in K1_CASES])
def test_k1_walk_is_the_plain_stack(c, v, name):
    b, t = _k1_shape(c, v, name)
    x, ks = _inputs(b, c, t, seed=c + t)
    checks = {}
    y = k1_stack(x, ks, variant=v, checks=checks)
    ref = plain_residual_stack(x, ks)
    assert torch.equal(checks["y_writes"], torch.ones_like(checks["y_writes"]))
    assert rel_err(y, ref) <= K1_TOL
    tile = K1_PLANS[c, v][0]
    for t0, writes in checks["tiles"]:
        for u in range(3):
            j_lo = HALO - HALOS[u]
            want = torch.zeros_like(writes["x", u])
            want[j_lo : j_lo + tile + 2 * HALOS[u]] = 1
            assert torch.equal(writes["x", u], want), (t0, u)
            want = torch.zeros_like(writes["h1", u])
            want[j_lo : j_lo + 16 * m_tiles(tile, u)] = 1
            assert torch.equal(writes["h1", u], want), (t0, u)
    assert_conflict_free(checks["row_addrs"])


def test_k1_single_tf32_pass_misses_the_bar_at_c128():
    """The same walk with one TF32 product (hi.hi) instead of three misses
    K1's float32 bar at C = 128, so the split carries the accuracy."""
    x, ks = _inputs(1, 128, 30, seed=3)
    ref = plain_residual_stack(x, ks)
    three = rel_err(k1_stack(x, ks, variant=1), ref)
    one = rel_err(k1_stack(x, ks, variant=1, passes=1), ref)
    assert three <= K1_TOL < one, (three, one)


@pytest.mark.parametrize("c", (32, 64, 128))
def test_k1_plans_fit_and_fill(c):
    """Each plan's shared memory leaves the blocks per SM its launch bounds
    promise (a thread may then take 65536 / (256 x blocks) >= 80 registers);
    the warps cover the widest window; the second plan gives at least as
    many blocks as the first, and at batch 1 the eval shapes give blocks to
    at least half the SMs."""
    for v in (0, 1):
        tile, kc, mw, nw, blocks = K1_PLANS[c, v]
        assert SMEM_PER_SM // (k1_smem_bytes(c, v) + SMEM_RESERVED) >= blocks
        assert 65536 // (256 * blocks) >= 80
        assert m_tiles(tile, 0) <= (WARPS // (c // (8 * nw))) * mw
    assert K1_PLANS[c, 1][0] <= K1_PLANS[c, 0][0]
    t = {32: 9984, 64: 4992, 128: 1248}[c]  # the training T; eval runs it at batch 1
    assert k1_variant(1, c, t) == 1 and -(-t // K1_PLANS[c, 1][0]) >= SMS / 2
    assert k1_variant(32, c, t) == 0

