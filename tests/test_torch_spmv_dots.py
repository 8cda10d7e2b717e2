"""Kernel B6 (the stencil SpMV with the dots in its epilogue) on the CPU:
its twin's partials and their sum in the kernel's order, the launch
geometry it shares with B1 (``_kernels.spmv_plan``), its scratch and the
front end's argument errors.

The partials are one per DOTS_BLOCK = 256 rows, each the halving tree of
that row's products, so they depend on the vectors alone; the sum takes
thread t's rows t, t + 256, ... one after another, then the 256-thread
halving tree.  Those orders are checked bit for bit against numpy written
from that description; the dots against float64 ``w @ y`` to 1e-12
relative (f64 inputs of ~1e4-1e5 elements, whose rounding errors are
~1e-15 relative).  On the card the kernel is held against the twin bit
for bit (``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch

import cuda_mat_tpu_torch.models.problems as tprob
from cuda_mat_tpu_torch.ops import _kernels as K
from cuda_mat_tpu_torch.ops import stencil as tst

torch.set_num_threads(1)
B = K.DOTS_BLOCK


def _tree(rows: np.ndarray) -> np.ndarray:
    """The halving tree of each row of ``rows`` (r += r + h, h = n/2..1)."""
    v = rows.copy()
    while v.shape[1] > 1:
        h = v.shape[1] // 2
        v = v[:, :h] + v[:, h:]
    return v[:, 0]


def _sum_in_kernel_order(parts: np.ndarray) -> np.ndarray:
    """Thread t of 256: rows t, t + 256, ... in turn (0 where it has none),
    then the tree over the 256 threads; per column."""
    acc = np.zeros((B, parts.shape[1]), parts.dtype)
    for t in range(min(B, parts.shape[0])):
        a = parts[t].copy()
        for r in range(t + B, parts.shape[0], B):
            a = a + parts[r]
        acc[t] = a
    return _tree(acc.T)


@pytest.mark.parametrize("rows", [1, 168, 256, 300, 1025])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dots_sum_takes_the_kernels_order(rows, dtype):
    rng = np.random.default_rng(rows)
    parts = rng.standard_normal((rows, 2)) * 10.0 ** rng.integers(
        -4, 5, (rows, 2))
    parts = parts.astype(np.float32 if dtype == torch.float32
                         else np.float64)
    got = tst.dots_sum_plain(torch.from_numpy(parts))
    assert got.dtype == dtype and got.shape == (2,)
    assert got.numpy().tobytes() == _sum_in_kernel_order(parts).tobytes()
    if dtype == torch.float64:
        want = [math.fsum(parts[:, d]) for d in range(2)]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def _layouts():
    """(name, op, x_pad, w_pad, base) on the CPU: the 10000-row grid, a
    block that is not a power of two, and a shard's base inside the vector
    (x and w random in the pad blocks too, as a shard's halo would be)."""
    rng = np.random.default_rng(4)
    out = []
    for name, (r, c), base in (("100x100", (100, 100), 0),
                               ("6x3163", (6, 3163), 0),
                               ("17x30, base 1000", (17, 30), 1000)):
        op = tst.ConstStencilOperator.from_dia(
            tprob.grid_laplacian(r, c).to_dia(max_diags=16),
            dtype=torch.float64, device="cpu")
        if base:
            x, w = (torch.from_numpy(rng.standard_normal(
                op.npad + 2 * op.block)) for _ in range(2))
        else:
            x, w = (op.pad_vec(rng.standard_normal(op.n)) for _ in range(2))
        out.append((name, op, x, w, base))
    return out


def test_twin_dots_equal_float64_dots():
    for name, op, x, w, base in _layouts():
        args = (op.strided_terms, op.np_true, op.block, op.sub)
        y, d = tst.const_stencil_spmv_dots_padded(x, op.gapmask, (w,), *args,
                                                  with_self=True, base=base)
        assert torch.equal(y, tst.const_stencil_spmv_padded(
            x, op.gapmask, *args, base)), name
        yn, wn = y.numpy(), w.numpy()
        inner = slice(op.block, op.block + op.npad)   # y is 0 in the pads
        want = [float(wn[inner] @ yn[inner]), float(yn @ yn)]
        np.testing.assert_allclose(d.numpy(), want, rtol=1e-12, err_msg=name)
        _, d1 = tst.const_stencil_spmv_dots_padded(x, op.gapmask, (), *args,
                                                   with_self=True, base=base)
        assert torch.equal(d1, d[1:]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_partials_one_per_256_rows(dtype):
    """A row of partials per 256 rows of y, each the tree of that row's
    products and nothing else's, 0 in the pad blocks; a change of y in one
    row of 256 moves that row's partials alone."""
    for name, op, x, w, base in _layouts():
        x, w, gap = x.to(dtype), w.to(dtype), op.gapmask.to(dtype)
        y = tst.const_stencil_spmv_padded(x, gap, op.strided_terms,
                                          op.np_true, op.block, op.sub, base)
        p = tst.spmv_dots_partials_plain(y, (w,), True, op.block)
        assert p.shape == (y.shape[0] // B, 2), name
        pad = op.block // B
        assert not p[:pad].any() and not p[p.shape[0] - pad:].any(), name
        yn, wn = y.numpy().reshape(-1, B), w.numpy().reshape(-1, B)
        inner = slice(pad, p.shape[0] - pad)
        assert p[inner, 0].numpy().tobytes() == _tree(
            wn * yn)[inner].tobytes(), name
        assert p[inner, 1].numpy().tobytes() == _tree(
            yn * yn)[inner].tobytes(), name
        row = pad + 3
        y2 = y.clone()
        y2[row * B + 17] += 1.0
        p2 = tst.spmv_dots_partials_plain(y2, (w,), True, op.block)
        moved = (p2 != p).any(dim=1).nonzero().flatten().tolist()
        assert moved == [row], name
        _, d = tst.const_stencil_spmv_dots_padded(
            x, gap, (w,), op.strided_terms, op.np_true, op.block, op.sub,
            with_self=True, base=base)
        assert torch.equal(d, tst.dots_sum_plain(p)), name


def _plan_layouts():
    """(name, npad, block, reach) of B6 on its paths and at the edge of its
    geometry: the fuse_blas1 layout of the flagship (paths (ii) and (iii)
    use it and path 1's), the 10000-row grid's and terms eight grid rows
    of 3200 away on a 409600 block, whose ring does not fit and shrinks."""
    terms = ((-100, 0, -1.0), (-1, -1, -1.0), (0, 0, 4.0), (1, 1, -1.0),
             (100, 0, -1.0))
    out = []
    for name, r, kw in (("fuse_blas1", 100000, {"fuse_blas1": True}),
                        ("flagship", 100000, {}), ("10000 rows", 100, {})):
        min_sub, cap, _ = tst.plan_const_neumann_layout(terms, 4, 100, 128,
                                                        **kw)
        stride, sub, block, np_true, npad, st_ = tst.stencil_layout(
            100, r * 100, terms, cap, min_sub)
        out.append((name, npad, block, max(abs(t[0]) for t in st_)))
    out.append(("halo shrinks", 409600, 409600, 8 * 3200))
    return out


@pytest.mark.parametrize("itemsize", [4, 8])
def test_spmv_plan_counts_the_epilogue(itemsize):
    """B6 runs on B1's plan: its epilogue holds the partial tree in
    registers (one warp a 256-row chunk, at most 8 chunks a tile, 8 / vec
    16-byte words a lane) and sums the partials through the ring's first
    2 x 256 elements, so the plan's shared memory is B1's and fits."""
    layouts = _plan_layouts()
    assert {n: b for n, _, b, _ in layouts}["fuse_blas1"] == 88064
    for name, npad, block, reach in layouts:
        p = K.spmv_plan(npad, block, reach, itemsize, 132)
        assert p.smem == (p.stages + 2) * p.tile * itemsize + 8 * p.stages
        assert p.smem <= K.SMEM_LIMIT - K.STATIC_SMEM, name
        assert p.tile % B == 0 and p.tile // B <= 8, name
        assert B // p.vec % 32 == 0, name   # a chunk's words fill warp lanes
        assert 2 * B <= p.stages * p.tile, name   # the final sum's scratch
        assert npad % p.tile == 0 and block % p.tile == 0, name
        if name == "halo shrinks":
            assert p.halo * p.tile < reach, name
        else:
            assert p.halo * p.tile >= reach, name
    fb = layouts[0]
    if itemsize == 4:
        assert K.spmv_plan(*fb[1:], 4, 132) == K.SpmvPlan(2048, 1, 5, 396,
                                                          57384, 4)


def test_front_end_argument_errors(monkeypatch):
    op = tst.ConstStencilOperator.from_dia(
        tprob.grid_laplacian(20, 30).to_dia(max_diags=16),
        dtype=torch.float64, device="cpu")
    x = op.pad_vec(np.ones(op.n))
    lay = (op.strided_terms, op.np_true, op.block, op.sub)
    for ws, with_self in (((x, x), True), ((), False)):
        with pytest.raises(ValueError, match="one weight"):
            tst.const_stencil_spmv_dots_padded(x, op.gapmask, ws, *lay,
                                               with_self=with_self)
    with pytest.raises(ValueError, match="gapmask"):
        tst.const_stencil_spmv_dots_padded(x, op.gapmask[1:], (x,), *lay)
    with pytest.raises(ValueError, match="gapmask"):
        tst.const_stencil_spmv_dots_padded(x, op.gapmask, (x[1:],), *lay)
    with pytest.raises(ValueError, match="halo"):
        tst.const_stencil_spmv_dots_padded(
            x, op.gapmask, (x,), ((op.sub + 1, 1.0),), *lay[1:])
    # the launcher's checks before it builds anything (meta tensors stand
    # in for CUDA ones)
    tst.reset_launch_counts()
    big = torch.empty(2 ** 31, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="32-bit"):
        tst.const_stencil_spmv_dots_padded(
            big, torch.empty(1 << 20, device="meta"), (big,),
            ((0, 1.0),), 2 ** 30, 1 << 20, 1024, True)
    meta = torch.empty(x.shape[0] + 2, dtype=torch.float64, device="meta")
    many = tuple((k, 1.0) for k in range(K.MAX_TERMS + 1))
    with pytest.raises(ValueError, match="stencil terms"):
        K.const_stencil_spmv_dots(meta[:-2], op.gapmask.to("meta"), (), many,
                                  op.np_true, op.block, 0, True)
    with pytest.raises(ValueError, match="one weight"):
        K.const_stencil_spmv_dots(meta[:-2], op.gapmask.to("meta"),
                                  (meta[:-2],) * 2, lay[0], op.np_true,
                                  op.block, 0, True)
    # past the device checks (here faked): a weight that is not 16-byte
    # aligned, and a block the streaming tiles cannot divide
    monkeypatch.setattr(K, "library", lambda: None)
    monkeypatch.setattr(K, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(K, "_sm_count", lambda device: 132)
    with pytest.raises(ValueError, match="16-byte"):
        K.const_stencil_spmv_dots(meta[:-2], op.gapmask.to("meta"),
                                  (meta[1:-1],), lay[0], op.np_true,
                                  op.block, 0, True)
    odd = torch.empty(3 * 1536, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="multiples"):
        K.const_stencil_spmv_dots(odd, odd[:1536], (odd,), ((0, 1.0),),
                                  1536, 1536, 0, True)
    assert tst.const_stencil_spmv_dots_padded.launches == 0


def test_scratch_is_made_once_and_never_inside_a_capture(monkeypatch):
    """The ticket is made once per device and stream, zeroed, and never
    while a CUDA graph captures; a second stream gets a ticket of its own
    (the CPU stands in for the card's memory here, integers for streams)."""
    monkeypatch.setattr(K, "_dots_tickets", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    dev = torch.device("cpu")
    t1 = K._dots_ticket(dev, 7)
    assert t1.dtype == torch.int32 and t1.tolist() == [0]
    assert K._dots_ticket(dev, 7) is t1
    t2 = K._dots_ticket(dev, 8)
    assert t2 is not t1 and t2.tolist() == [0]
    assert t2.data_ptr() != t1.data_ptr()
    assert K._dots_ticket(torch.device("meta"), 7) is not t1
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert K._dots_ticket(dev, 7) is t1 and K._dots_ticket(dev, 8) is t2
    with pytest.raises(RuntimeError, match="capture"):
        K._dots_ticket(dev, 9)
