"""K2's bf16 tensor-core path, emulated on the CPU in float64.

``vibravox_tpu_torch/ops/csrc/fused_residual_bwd.cu`` runs every channel
product of its bf16 instantiations on ``mma.sync.aligned.m16n8k16`` (bf16 A
and B, f32 C) in two device helpers, ``channel_product`` and
``gram_product``.  A CUDA kernel cannot run here, so this file writes out
the same index arithmetic in torch: the three fragment maps of the PTX ISA,
one m16n8k16 step built from them, the staged weight chunks, and the order
in which the kernel's warps walk their tiles.  The walks are held to
``torch.einsum`` at 1e-12 of scale, and one unit's dx (the mma product plus
the reflect pad's fold terms, added off the tensor cores) to autograd of
one plain unit.  Every output cell must be written exactly once.  No JAX.
"""

import pytest
import torch
import torch.nn.functional as F
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)


WARPS = 8  # kThreads / 32
MAX_D = 9  # kMaxD
IC = 16  # kIc: reduction channels per staged weight chunk
WS_PAD = 4  # kWsPad
TILES = {32: 224, 64: 96, 128: 46}  # the TILE of each channel count (grid_for, dispatch)

LANE = torch.arange(32)
G, Q = LANE >> 2, LANE & 3


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


def stage(w, r0, transposed):
    """stage_weights: the chunk r0 .. r0 + 16 of reduction channels of w
    (C, C, KT) into the flat ws[(ii KT + k) kWs + output channel]."""
    c, _, kt = w.shape
    kws = c + WS_PAD
    wf = w.reshape(-1)
    ws = torch.full((IC * 3 * kws,), float("nan"), dtype=w.dtype)
    e = torch.arange(c * IC * kt)
    if not transposed:
        o, r = e // (IC * kt), e % (IC * kt)
        ws[r * kws + o] = wf[o * c * kt + r0 * kt + r]
    else:
        r, i = e // c, e % c
        oo, k = r // kt, r % kt
        ws[r * kws + i] = wf[(r0 + oo) * c * kt + i * kt + k]
    return ws


def channel_product(w, operand, n_pos, transposed, touches=None, fold=None):
    """The bf16 branch of channel_product: Y (C, n_pos) and the number of
    times each cell was written.  operand(ch, k, p) and fold(ch, k, p) take
    index tensors; touches(p) says which positions take fold terms."""
    c, _, kt = w.shape
    kws = c + WS_PAD
    m_tiles = c // 16
    n_stride = WARPS // m_tiles
    k_tiles = (-(-(TILES[c] + 2 * MAX_D) // 8) + n_stride - 1) // n_stride
    assert k_tiles <= 8  # the accumulators: at most 8 tiles of 4 floats a thread
    n_tiles = -(-n_pos // 8)
    warp = torch.arange(WARPS)
    o0 = (warp % m_tiles * 16)[:, None, None, None]  # (warp, tile, lane, value)
    nt = ((warp // m_tiles)[:, None] + n_stride * torch.arange(k_tiles)[None, :])[:, :, None, None]
    (ar, ac), (br, bc), (cr, cc) = a_map(), b_map(), c_map()
    acc = torch.zeros(WARPS, k_tiles, 32, 4, dtype=w.dtype)
    p_b = nt * 8 + bc  # B's position n = g
    p_c = nt * 8 + cc  # C's positions 2q, 2q + 1
    o_c = o0 + cr
    zero = torch.zeros((), dtype=w.dtype)
    for r0 in range(0, c, IC):
        ws = stage(w, r0, transposed)
        for k in range(kt):
            a = ws[(ac * kt + k) * kws + o0 + ar]  # A[m][kk] = ws[(kk KT + k) kWs + o0 + m]
            b = torch.where(p_b < n_pos, operand(r0 + br, k, p_b.clamp(max=n_pos - 1)), zero)
            acc = torch.where(nt < n_tiles, mma(a.expand(-1, k_tiles, -1, -1), b, acc), acc)
        if touches is not None:
            hit = (p_c < n_pos) & touches(p_c.clamp(max=n_pos - 1))
            for ii in range(IC):
                for k in range(kt):
                    term = ws[(ii * kt + k) * kws + o_c] * fold(r0 + ii, k, p_c.clamp(max=n_pos - 1))
                    acc = torch.where(hit, acc + term, acc)
    out = torch.zeros(c, n_pos, dtype=w.dtype)
    writes = torch.zeros(c, n_pos, dtype=torch.long)
    keep = (p_c < n_pos).expand_as(acc)
    cells = (o_c * n_pos + p_c).expand_as(acc)[keep]
    out.view(-1).index_put_((cells,), acc[keep], accumulate=True)
    writes.view(-1).index_put_((cells,), torch.ones_like(cells), accumulate=True)
    return out, writes


def gram_batch(n):
    b = min(n, 8)
    while n % b:
        b -= 1
    return b


def gram_product(a_mat, b_mat, j_lo, n, step, kt, out=None):
    """The bf16 branch of gram_product: out[o, i, k] (+)= sum_{j < n}
    A[o, j_lo + j] B[i, j_lo + j + k step] (``first`` when out is None),
    and the number of times each cell was written."""
    c = a_mat.shape[0]
    m_tiles, n_tiles = c // 16, c // 8
    warps_per_m = WARPS // m_tiles
    assert (kt * n_tiles) % warps_per_m == 0
    per_warp = kt * n_tiles // warps_per_m
    batch = gram_batch(per_warp)
    first = out is None
    out = torch.zeros(c, c, kt, dtype=a_mat.dtype) if first else out.clone()
    writes = torch.zeros(c, c, kt, dtype=torch.long)
    (ar, ac), (br, bc), (cr, cc) = a_map(), b_map(), c_map()
    zero = torch.zeros((), dtype=a_mat.dtype)

    def at(mat, row, col, j0):  # row[j0 + jj], 0 past n
        jj = j0 + col
        return torch.where(jj < n, mat[row, (j_lo + jj).clamp(max=mat.shape[1] - 1)], zero)

    for warp in range(WARPS):
        o0, u0 = warp % m_tiles * 16, warp // m_tiles
        for v0 in range(0, per_warp, batch):
            u = u0 + warps_per_m * (v0 + torch.arange(batch))  # the batch's (k, n-tile) pairs
            k, i0 = u // n_tiles, (u % n_tiles) * 8
            acc = torch.zeros(batch, 32, 4, dtype=a_mat.dtype)
            for j0 in range(0, n, 16):
                a = at(a_mat, o0 + ar, ac, j0)
                jb = j0 + br
                rows = (i0[:, None, None] + bc)
                cols = j_lo + jb + k[:, None, None] * step
                b = torch.where(jb < n, b_mat[rows, cols.clamp(max=b_mat.shape[1] - 1)], zero)
                acc = mma(a.expand(batch, -1, -1), b, acc)
            o = (o0 + cr).expand(batch, -1, -1)
            i = i0[:, None, None] + cc
            kk = k[:, None, None].expand(-1, 32, 4)
            out[o, i, kk] = acc if first else out[o, i, kk] + acc
            writes.index_put_((o, i, kk), torch.ones_like(o), accumulate=True)
    return out, writes


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


def _ragged(c):
    return TILES[c] // 3 + 5  # not a multiple of 8 at any C


@pytest.mark.parametrize("window", ["tile_and_halo", "ragged"])
@pytest.mark.parametrize("transposed", [False, True], ids=["w", "wT"])
@pytest.mark.parametrize("kt", [1, 3])
@pytest.mark.parametrize("c", [32, 64, 128])
def test_channel_product_walk_is_the_product(c, kt, transposed, window):
    d = MAX_D if kt == 3 else 0
    n_pos = TILES[c] + 2 * MAX_D if window == "tile_and_halo" else _ragged(c)
    gen = torch.Generator().manual_seed(c + kt + n_pos)
    w = torch.randn(c, c, kt, generator=gen, dtype=torch.float64)
    x = torch.randn(c, n_pos + 2 * d, generator=gen, dtype=torch.float64)
    y, writes = channel_product(w, lambda ch, k, p: x[ch, p + k * d], n_pos, transposed)
    taps = torch.stack([x[:, k * d : k * d + n_pos] for k in range(kt)], -1)  # (ch, p, k)
    ref = torch.einsum("oik,ipk->op" if not transposed else "oik,opk->ip", w, taps)
    assert torch.equal(writes, torch.ones_like(writes))
    assert (y - ref).abs().max() <= 1e-12 * ref.abs().max()


@pytest.mark.parametrize("own", ["tile", "ragged"])
@pytest.mark.parametrize("kt", [1, 3])
@pytest.mark.parametrize("c", [32, 64, 128])
def test_gram_product_walk_is_the_product(c, kt, own):
    """dWp (kt 1, no shift) and dWd (kt 3, shifts k d at d = 9) over the
    owned window columns d .. d + n of a tile, called twice as for two tiles
    of one block (the second adds to the first)."""
    d = MAX_D
    n = TILES[c] if own == "tile" else _ragged(c)
    wg, wx = TILES[c] + 2 * d, TILES[c] + 4 * d
    gen = torch.Generator().manual_seed(c * kt + n)
    mats = [(torch.randn(c, wg, generator=gen, dtype=torch.float64),
             torch.randn(c, wx if kt == 3 else wg, generator=gen, dtype=torch.float64)) for _ in range(2)]
    step = d if kt == 3 else 0
    out, writes = gram_product(*mats[0], d, n, step, kt)
    assert torch.equal(writes, torch.ones_like(writes))
    out, writes = gram_product(*mats[1], d, n, step, kt, out=out)
    assert torch.equal(writes, torch.ones_like(writes))
    ref = sum(torch.stack([torch.einsum("oj,ij->oi", a[:, d : d + n], b[:, d + k * step : d + k * step + n])
                           for k in range(kt)], -1) for a, b in mats)
    assert (out - ref).abs().max() <= 1e-12 * ref.abs().max()


def _plain_unit(x, wd, wp, d, slope):
    h = F.conv1d(F.pad(x, (d, d), mode="reflect"), wd, dilation=d)
    return x + F.leaky_relu(F.conv1d(h, wp), slope)


@pytest.mark.parametrize("c,t_len", [(32, 40), (64, 40), (128, 40), (128, 100)])
def test_unit_dx_is_mma_product_plus_fold(c, t_len):
    """One unit at d = 9: dh1 as the kernel forms it, then per time tile the
    dx product on the tensor cores over the plain shifted operand, plus the
    fold terms (the reflect pad's transpose) in f32, against autograd of
    one plain unit.  Without the fold terms dx is wrong at the edges."""
    d, slope, tile = 9, 0.01, TILES[c]
    gen = torch.Generator().manual_seed(c + t_len)
    x = torch.randn(1, c, t_len, generator=gen, dtype=torch.float64)
    wd = torch.randn(c, c, 3, generator=gen, dtype=torch.float64) / c
    wp = torch.randn(c, c, 1, generator=gen, dtype=torch.float64) / c
    g = torch.randn(1, c, t_len, generator=gen, dtype=torch.float64)
    xr = x.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(_plain_unit(xr, wd, wp, d, slope), xr, g)

    h2 = F.conv1d(F.conv1d(F.pad(x, (d, d), mode="reflect"), wd, dilation=d), wp)
    dh1 = torch.einsum("oi,ot->it", wp[..., 0], torch.where(h2[0] >= 0, g[0], slope * g[0]))
    dx, dx_unfolded = torch.empty(c, t_len, dtype=x.dtype), torch.empty(c, t_len, dtype=x.dtype)
    for t0 in range(0, t_len, tile):
        n_own = min(tile, t_len - t0)
        times = t0 - d + torch.arange(tile + 2 * MAX_D)  # hs column j is time t0 - d + j
        inside = (times >= 0) & (times < t_len)
        hs = torch.where(inside, dh1[:, times.clamp(0, t_len - 1)], torch.zeros((), dtype=x.dtype))
        left_hi, right_lo = d, t_len - 1 - d

        def operand(ch, k, p):
            return hs[ch, p + d - (k - 1) * d]

        def touches(p):
            s = t0 + p
            return ((s >= 1) & (s <= left_hi)) | ((s >= right_lo) & (s <= t_len - 2))

        def fold(ch, k, p):
            s = t0 + p
            zero = torch.zeros((), dtype=x.dtype)
            if k == 0:
                col = ((d - s) - (t0 - d)).clamp(0, hs.shape[1] - 1)
                return torch.where((s >= 1) & (s <= left_hi), hs[ch, col], zero)
            if k == 2:
                col = ((2 * (t_len - 1) - s - d) - (t0 - d)).clamp(0, hs.shape[1] - 1)
                return torch.where((s >= right_lo) & (s <= t_len - 2), hs[ch, col], zero)
            return torch.zeros(torch.broadcast_shapes(torch.as_tensor(ch).shape, p.shape), dtype=x.dtype)

        y, writes = channel_product(wd, operand, n_own, True, touches, fold)
        assert torch.equal(writes, torch.ones_like(writes))
        dx[:, t0 : t0 + n_own] = g[0, :, t0 : t0 + n_own] + y
        y0, _ = channel_product(wd, operand, n_own, True)
        dx_unfolded[:, t0 : t0 + n_own] = g[0, :, t0 : t0 + n_own] + y0
    scale = ref.abs().max()
    assert (dx - ref[0]).abs().max() <= 1e-12 * scale
    assert (dx_unfolded - ref[0]).abs().max() > 1e-3 * scale
