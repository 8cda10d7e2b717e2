"""The launch geometry of kernels B2 and B5 (``_kernels.msolve_plan``),
checked on the CPU: it is pure Python, and the kernel takes it as given.

At the mat10000, flagship and fuse_blas1 layouts of the 5-point Laplacian's
Neumann series (k = 4, stride 128) and at the bench grid's stride 3200, whose
terms reach past a tile, for B2 and both forms of B5, in f32 and f64: the
persistent blocks' runs cover every tile once, the tile divides the layout
block, the rings hold what the terms read and fit shared memory.  Every
layout the previous shared-memory rule accepted (the u tile and its halo,
``(tile + 2·h_u)·itemsize`` bytes, and for B5 also p over P_l's window) is
still accepted, and the plan's modes change where their rings stop fitting.
"""

import pytest

from cuda_mat_tpu_torch.ops import _kernels as K

SMS = 132   # an H100's SMs: only the grid depends on it


def _neumann(stride, degree=3):
    """The offsets of a 5-point Laplacian's Neumann series to ``degree``:
    P_l's a + b·stride steps down, P_u's up (coefficients play no part)."""
    offs = sorted({a + b * stride for a in range(degree + 1)
                   for b in range(degree + 1 - a)})
    return (tuple((-o, 1.0) for o in reversed(offs)),
            tuple((o, 1.0) for o in offs))


FLAG_L, FLAG_U = _neumann(128)
WIDE_L, WIDE_U = _neumann(3200)
LAYOUTS = {   # name: (npad, block, terms_l, terms_u)
    "mat10000": (14336, 14336, FLAG_L, FLAG_U),
    "flagship": (12847104, 104448, FLAG_L, FLAG_U),
    "fuse_blas1": (12857344, 88064, FLAG_L, FLAG_U),
    "reach past a tile (stride 3200)": (10137600, 102400, WIDE_L, WIDE_U),
}


@pytest.mark.parametrize("nin", [1, 2, 3])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plan_covers_each_tile_once_and_fits(layout, itemsize, nin):
    npad, block, tl, tu = LAYOUTS[layout]
    p = K.msolve_plan(npad, block, tl, tu, itemsize, nin, SMS)
    assert p.nin == nin and block % p.tile == 0 and npad % p.tile == 0
    assert p.tile & (p.tile - 1) == 0 and p.tile * itemsize <= K.STAGE_BYTES
    # the kernel's runs: block b owns tiles [b n / ctas, (b + 1) n / ctas)
    n = npad // p.tile
    assert 1 <= p.ctas <= min(n, SMS * p.blocks)
    runs = [(b * n // p.ctas, (b + 1) * n // p.ctas) for b in range(p.ctas)]
    tiles = [t for t0, t1 in runs for t in range(t0, t1)]
    assert tiles == list(range(n))
    assert min(t1 - t0 for t0, t1 in runs) >= 1
    assert max(t1 - t0 for t0, t1 in runs) == p.run
    # shared memory: as the launcher counts it, beside the static terms
    assert p.smem == K._msolve_smem(p.tile, nin, p.stages, p.xlo, p.xhi,
                                    (p.gp_lo, p.gp_hi), p.ru,
                                    (p.gu_lo, p.gu_hi), itemsize)
    assert p.smem + K.STATIC_SMEM <= K.SMEM_LIMIT
    assert p.blocks == K._blocks_per_sm(p.smem,
                                     K.MSOLVE_BLOCKS_PER_SM[p.tile // 256])
    # the u ring holds P_u's whole reach; the p ring what it serves
    (ll, lh), (ul, uh) = K._reach(tl), K._reach(tu)
    assert p.ulo * p.tile >= ul and p.uhi * p.tile >= uh
    assert not p.wrap and p.ru == (p.ulo + p.uhi + 1) * p.tile
    assert p.gu_lo >= ul and p.gu_hi >= uh
    assert p.gp_lo <= p.xlo * p.tile and p.gp_hi <= p.xhi * p.tile
    vec = 16 // itemsize
    assert all(v % vec == 0 for v in (p.gp_lo, p.gp_hi, p.gu_lo, p.gu_hi,
                                      p.ru))
    assert p.stages >= 1
    if layout == "reach past a tile (stride 3200)":
        # u's ring spans several tiles; P_l's reach stays in the p ring
        # where both fit (f32), else its far terms read device memory
        assert p.ulo == 0 and p.uhi * p.tile >= 9600 > p.tile
        assert ((p.gp_lo, p.gp_hi) == (ll, lh)) == (itemsize == 4)
    else:
        # P_l's whole reach in the p ring, two blocks an SM at least
        assert (p.gp_lo, p.gp_hi) == (ll, lh) and p.blocks >= 2


def _parent_fits(block, h_l, h_u, itemsize):
    """The rule kernels B2 took layouts by before they streamed: a u tile
    of 2048 rows (1024 where block is no multiple of 2048) and its halo
    h_u on each side in shared memory."""
    tile = 2048 if block % 2048 == 0 else 1024
    return (h_l + h_u <= block and block % 1024 == 0
            and (tile + 2 * h_u) * itemsize <= K.SMEM_LIMIT)


def _parent_fma_fits(block, h_l, h_u, itemsize):
    """B5's rule then: B2's, and p over P_l's window beside the u tile."""
    tile = 2048 if block % 2048 == 0 else 1024
    return (_parent_fits(block, h_l, h_u, itemsize)
            and (2 * tile + 4 * h_u + 2 * h_l) * itemsize <= K.SMEM_LIMIT)


def _terms(h_l, h_u, sym):
    """P_l reaching h_l rows down, P_u h_u rows up (and down with sym)."""
    tl = ((-h_l, 0.5), (0, 1.0)) if h_l else ((0, 1.0),)
    tu = ((0, 1.0),) + (((h_u, 0.25),) if h_u else ())
    if sym and h_u:
        tu = ((-h_u, 0.125),) + tu
    return tl, tu


@pytest.mark.parametrize("itemsize", [4, 8])
def test_plan_accepts_every_layout_the_parent_did(itemsize):
    """Over blocks, P_l reaches and P_u reaches (one-sided, as the Neumann
    factors are, and two-sided), up to and just past the parent rule's
    boundary: wherever it accepted, B2 and B5 still do."""
    seen = 0
    for block in (1024, 3 * 1024, 14336, 88064, 104448, 1 << 17):
        tile = 2048 if block % 2048 == 0 else 1024
        edge = (K.SMEM_LIMIT // itemsize - tile) // 2   # the parent's h_u max
        for h_u in sorted({0, 1, 384, 1500, 5000, edge - 1, edge, edge + 1}):
            for h_l in sorted({0, 384, max(0, block - h_u)}):
                if h_l + h_u > block:
                    continue
                for sym in (False, True):
                    tl, tu = _terms(h_l, h_u, sym)
                    if _parent_fits(block, h_l, h_u, itemsize):
                        seen += 1
                        assert K.msolve_fits(block, tl, tu, itemsize), \
                            (block, h_l, h_u, sym)
                        for nin in (1, 2, 3):
                            K.msolve_plan(block, block, tl, tu, itemsize,
                                          nin, SMS)
                    if _parent_fma_fits(block, h_l, h_u, itemsize):
                        assert K.msolve_fma_fits(block, tl, tu, itemsize), \
                            (block, h_l, h_u, sym)
    assert seen > 100


@pytest.mark.parametrize("itemsize,h_ring,h_wrap,h_lean,h_none", [
    (4, 9000, 20000, 28000, 29000),
    (8, 6000, 9000, 14000, 14300)])
def test_plan_modes_at_their_boundaries(itemsize, h_ring, h_wrap, h_lean,
                                        h_none):
    """As P_u reaches farther both ways (block 2^17), the u ring first keeps
    its copied edges, then wraps each read, then leaves no room for the
    other rings (lean mode: inputs from device memory), then does not fit
    at all; a P_l term far past a tile reads device memory."""
    block = 1 << 17

    def plan(h, nin=1):
        tl, tu = _terms(1, h, True)
        return K.msolve_plan(2 * block, block, tl, tu, itemsize, nin, SMS)

    for nin in (1, 3):
        p = plan(h_ring, nin)
        assert p.stages >= 1 and not p.wrap and p.gu_lo >= h_ring
        p = plan(h_wrap, nin)
        assert p.stages >= 1 and p.wrap and p.gu_lo == p.gu_hi == 0
        p = plan(h_lean, nin)
        assert p.stages == 0 and p.wrap
        assert p.ru >= p.tile + 2 * h_lean
    tl, tu = _terms(1, h_none, True)
    assert not K.msolve_fits(block, tl, tu, itemsize)
    assert not K.msolve_fma_fits(block, tl, tu, itemsize)
    with pytest.raises(ValueError, match="shared"):
        K.msolve_plan(2 * block, block, tl, tu, itemsize, 1, SMS)
    far = (((-60000, 0.5), (-1, -1.0), (0, 4.0), (1, -1.0)),
           ((0, 1.0), (1, -0.5), (128, 0.25)))
    p = K.msolve_plan(2 * block, block, *far, itemsize, 1, SMS)
    assert p.stages >= 1 and p.gp_lo < 60000 and p.xlo * p.tile < 60000


def test_plan_is_made_once_per_layout():
    npad, block, tl, tu = LAYOUTS["flagship"]
    p = K.msolve_plan(npad, block, tl, tu, 4, 1, SMS)
    hits = K.msolve_plan.cache_info().hits
    assert K.msolve_plan(npad, block, tl, tu, 4, 1, SMS) is p
    assert K.msolve_plan.cache_info().hits == hits + 1


def test_plan_refuses_layouts_the_kernel_does_not_take():
    tl, tu = _terms(384, 384, False)
    with pytest.raises(ValueError, match="block"):
        K.msolve_plan(3 * 1536, 1536, tl, tu, 4, 1, SMS)   # block % 1024
    with pytest.raises(ValueError, match="block"):
        K.msolve_plan(2048, 2048, *_terms(1500, 1000, False), 4, 1, SMS)
    with pytest.raises(ValueError, match="terms"):
        K.msolve_plan(2048, 2048, tuple((-i, 1.0) for i in range(65)), tu,
                      4, 1, SMS)
