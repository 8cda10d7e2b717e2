"""Iteration counts of the distributed solves whose windows
``chip_smoke.py``'s path 7 holds, over the shard count: the JAX package
(its "xla" engine, CPU) beside the port (CPU).  In each, the count moves
with the order in which the dots are summed, so with N; the spread of the
JAX package's counts over the layouts of one system is the reference's
own, and sets the window.

- ``neumann R``: path 7 (a)'s configuration on ``grid_laplacian(R, 100)``:
  exact ILU(0) factors, Neumann series k = 3, f32, tol 1e-4, b = x0 =
  ones, on N = 1, 2, 4, 8 row shards; beside it the one-device solve of
  the same series (the port on the banded DIA operator,
  ``format="pallas_dia"``, path 3 (a); the JAX package on its XLA DIA
  operator).
- ``hform R``: path 7 (b)'s, f64, tol 1e-6, no preconditioner and Jacobi,
  one device (``format="dia"``) and N = 1, 2, 4, 8.
- ``neumann-ulp R K``: ``neumann R`` again for b = ones and K − 1 one-ulp
  (f32) changes of it (entry ``rng(seed).integers(n)`` moved up; seeds
  1..K−1):
  the same system in other rounding, a second witness beside the layouts.
- ``card-slack K``: ``tests/test_torch_parallel_card.py``'s solves
  (``banded_laplacian(40)``, tol 1e-8, 4 shards, b uniform in [1, 5) from
  seed 3) for each preconditioner, over that b and K − 1 one-ulp changes
  of it: both packages' counts, and how far they move.
- ``hform-pallas R``: ``hform R`` on the "pallas" engine (path 7 (g)'s
  1M solves through B3): the JAX package's interpret kernel a shard, the
  port's twin a shard, against the one-device DIA solves (the JAX
  interpret kernel takes minutes a solve past R = 1000).
- ``hform-ulp R K``: path 7 (b)'s and (g)'s f64 h-form on 4 shards over b
  = ones and K − 1 one-ulp (f64) changes of it: each package's one-device
  count and its "xla" engine's, and the port's "pallas" engine's (its
  twin of B3 a shard); the spread of the reference's counts over rounding
  at R = 10000, where the JAX interpret kernel is too slow to run.
- ``stencil R``: path 7 (f)'s, the flagship's configuration (const
  Neumann factors k = 4, MILU ω 0.96, f32, tol 1e-4, b = x0 = ones) on
  ``grid_laplacian(R, 100)``: one device (``format="stencil"``, path 1)
  and N = 1, 2, 4, 8 shards on the "stencil" engine (the JAX package's
  interpret kernels; the port's twins).
- ``shuffled SIDE K``: path 7 (d)'s, Jacobi, f64, tol 1e-6, on
  ``banded_laplacian(SIDE)`` numbered at random (the permutations of
  ``np.random.default_rng(seed)``, seeds 0..K−1; seed 0 is
  ``chip_smoke.shuffled_laplacian``): one device and N = 4 (an ELL
  partition and an all-gather of x).

Run as a script (one torch thread; the JAX solves use XLA's CPU threads):

    PYTHONPATH=. python tests/test_torch_parallel_scan.py neumann 500 1000 2000
    PYTHONPATH=. python tests/test_torch_parallel_scan.py hform 2000 10000
    PYTHONPATH=. python tests/test_torch_parallel_scan.py shuffled 316 4
    PYTHONPATH=. python tests/test_torch_parallel_scan.py neumann-ulp 1000 8
    PYTHONPATH=. python tests/test_torch_parallel_scan.py card-slack 16
    PYTHONPATH=. python tests/test_torch_parallel_scan.py stencil 500 1000
    PYTHONPATH=. python tests/test_torch_parallel_scan.py hform-pallas 500
    PYTHONPATH=. python tests/test_torch_parallel_scan.py hform-ulp 10000 6

(a few minutes each).  The tests check the smallest case and three b at
R = 1000.
"""

import os
import sys

if __name__ == "__main__":
    # the 8 virtual CPU devices tests/conftest.py gives the test run
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               "force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import torch  # noqa: E402

import cuda_mat_tpu as cm  # noqa: E402
import cuda_mat_tpu.formats.reorder as jreorder  # noqa: E402
import cuda_mat_tpu.parallel as jp  # noqa: E402
from cuda_mat_tpu.models.problems import grid_laplacian  # noqa: E402

import cuda_mat_tpu_torch as ct  # noqa: E402
import cuda_mat_tpu_torch.parallel as tp  # noqa: E402

SHARDS = (1, 2, 4, 8)
NEUMANN = dict(maxit=2000, tol=1e-4, dtype="float32", precond="ilu0_neumann",
               neumann_terms=3, neumann_const_factors=False)
HFORM = dict(maxit=5000, tol=1e-6, dtype="float64")
FLAGSHIP = dict(maxit=2000, tol=1e-4, dtype="float32", precond="ilu0_neumann",
                neumann_terms=4, milu_omega=0.96)


def _port(a):
    return ct.CSRMatrix(a.n, a.m, a.data, a.indices, a.indptr)


def nudged(b, seed, dtype=np.float64):
    """``b`` with entry ``rng(seed).integers(n)`` moved one ulp of
    ``dtype`` (the solve's) up; seed 0 leaves it as it is."""
    b = b.copy()
    if seed:
        k = np.random.default_rng(seed).integers(b.shape[0])
        b[k] = np.nextafter(dtype(b[k]), dtype(np.inf))
    return b


def counts(a, cfg, one_device_format, shards=SHARDS, b=None, strict=True,
           engine="xla"):
    """``{(package, layout): iterations}`` of ``cfg``'s solves of ``a``
    with ``b`` (ones by default): ``(package, "one device")`` on
    ``one_device_format`` (the port's "pallas_dia" is the JAX package's
    "dia"; None: none) and ``(package, N)`` over N row shards.  A solve
    that does not converge fails the call, or with ``strict=False`` stands
    as ``"STATUS@iterations"``, outside every spread.  ``engine``: the
    distributed solves' local engine."""
    b = np.ones(a.n) if b is None else b
    ta = _port(a)
    if one_device_format is None and shards:
        return _shard_counts(a, ta, b, cfg, shards, {}, strict, engine)
    jfmt = "dia" if one_device_format == "pallas_dia" else one_device_format
    rt = ct.solve(ta, b, ct.SolverConfig(**cfg), format=one_device_format,
                  device="cpu")
    rj = cm.solve(a, b, cm.SolverConfig(**cfg), format=jfmt)
    out = {("port", "one device"): _count(rt, strict),
           ("jax", "one device"): _count(rj, strict)}
    return _shard_counts(a, ta, b, cfg, shards, out, strict, engine)


def _count(r, strict):
    assert r.converged or not strict
    return r.iters if r.converged else f"{r.status.name}@{r.iters}"


def _shard_counts(a, ta, b, cfg, shards, out, strict, engine="xla"):
    for n in shards:
        rj = jp.dist_bicgstab(a, b, jp.make_mesh(n), cm.SolverConfig(**cfg),
                              local_engine=engine)
        rt = tp.dist_bicgstab(ta, b, tp.make_mesh(n, device="cpu"),
                              ct.SolverConfig(**cfg), local_engine=engine)
        out["jax", n], out["port", n] = _count(rj, strict), _count(rt, strict)
    return out


def spread(got, pkg="jax"):
    """The widest distance between two of a package's counts: its own
    spread over the layouts."""
    its = [v for (p, _), v in got.items() if p == pkg and isinstance(v, int)]
    return max(its) - min(its)


def farthest(got, pkg="jax"):
    """The largest distance of a package's N-shard count from its
    one-device count: what path 7 gates."""
    one = got[pkg, "one device"]
    return max((abs(v - one) for (p, k), v in got.items()
                if p == pkg and k != "one device" and isinstance(v, int)
                and isinstance(one, int)), default=None)


def report(tag, got):
    line = []
    for pkg in ("jax", "port"):
        its = {k: v for (p, k), v in got.items() if p == pkg}
        line.append(f"{pkg} {its} (spread {spread(got, pkg)}; farthest N"
                    f" from one device {farthest(got, pkg)})")
    print(f"{tag}: " + "; ".join(line), flush=True)


def test_neumann_counts_over_shards_lie_in_the_references_spread():
    torch.set_num_threads(1)
    got = counts(grid_laplacian(100, 100), NEUMANN, "pallas_dia")
    assert farthest(got, "port") <= max(5, farthest(got))


def test_neumann_counts_over_rounding_lie_in_the_references_spread():
    """At R = 1000 (100k rows) one b is no witness: with b = ones the
    port's N = 2 count lies 25 from its one-device count and the JAX
    package's farthest 12, but one f32 ulp of one entry of b moves the JAX
    package's farthest to 37 and 30 (``neumann-ulp 1000 8``).  So the rule
    is held over b = ones and two one-ulp changes of it: the port's
    farthest over all three within the JAX package's.  Over 8 b the JAX
    package's N-shard counts lie up to 37 from its one-device count, the
    port's up to 26.  Both packages' f32 solves break down now and then
    here (at one layout of 2 of the 8 b each): such a solve stands outside
    the counts, and must be a BREAKDOWN, never MAXIT."""
    torch.set_num_threads(1)
    a = grid_laplacian(1000, 100)
    far = {"jax": [], "port": []}
    for seed in range(3):
        got = counts(a, NEUMANN, "pallas_dia", strict=False,
                     b=nudged(np.ones(a.n), seed, np.float32))
        for pkg in far:
            if farthest(got, pkg) is not None:
                far[pkg].append(farthest(got, pkg))
        assert all(v.startswith("BREAKDOWN@") for v in got.values()
                   if not isinstance(v, int)), got
    assert max(far["port"]) <= max(5, max(far["jax"])), far


def main(argv):
    import jax

    jax.config.update("jax_enable_x64", True)     # as tests/conftest.py
    torch.set_num_threads(1)
    mode, sizes = argv[0], [int(v) for v in argv[1:]]
    if mode == "neumann":
        for r in sizes:
            report(f"neumann R={r} n={r * 100}",
                   counts(grid_laplacian(r, 100), NEUMANN, "pallas_dia"))
    elif mode == "hform":
        for r in sizes:
            for pre in ("none", "jacobi"):
                report(f"hform {pre} R={r} n={r * 100}", counts(
                    grid_laplacian(r, 100), dict(HFORM, precond=pre), "dia"))
    elif mode == "neumann-ulp":
        r, k = sizes
        a = grid_laplacian(r, 100)
        pooled = {"jax": [], "port": []}
        for seed in range(k):
            got = counts(a, NEUMANN, "pallas_dia", strict=False,
                         b=nudged(np.ones(a.n), seed, np.float32))
            report(f"neumann R={r} b seed {seed}", got)
            for pkg in pooled:
                pooled[pkg] += [v for (p, _), v in got.items()
                                if p == pkg and isinstance(v, int)]
        print(f"neumann R={r} pooled over {k} b: " + "; ".join(
            f"{pkg} {min(v)}..{max(v)} (spread {max(v) - min(v)})"
            for pkg, v in pooled.items()), flush=True)
    elif mode == "card-slack":
        from cuda_mat_tpu.models.problems import banded_laplacian

        (k,) = sizes
        a = banded_laplacian(40)
        b0 = np.random.default_rng(3).uniform(1.0, 5.0, a.n)
        for pre in ("none", "jacobi", "bjacobi_ilu0", "ilu0_neumann"):
            cfg = dict(maxit=2000, tol=1e-8, dtype="float64", precond=pre,
                       trisolve_block=64)
            its = {"jax": [], "port": []}
            for seed in range(k):
                got = counts(a, cfg, None, shards=(4,), b=nudged(b0, seed))
                its["jax"].append(got["jax", 4])
                its["port"].append(got["port", 4])
            print(f"card-slack {pre}, 4 shards, {k} b: " + "; ".join(
                f"{pkg} {v[0]} as given, {min(v)}..{max(v)} (spread"
                f" {max(v) - min(v)})" for pkg, v in its.items()),
                flush=True)
    elif mode == "hform-pallas":
        for r in sizes:
            for pre in ("none", "jacobi"):
                report(f"hform-pallas {pre} R={r} n={r * 100}", counts(
                    grid_laplacian(r, 100), dict(HFORM, precond=pre), "dia",
                    engine="pallas"))
    elif mode == "hform-ulp":
        r, k = sizes
        a = grid_laplacian(r, 100)
        pooled = {}
        for seed in range(k):
            b = nudged(np.ones(a.n), seed)
            got = counts(a, HFORM, "dia", shards=(4,), b=b)
            got["port pallas", 4] = tp.dist_bicgstab(
                _port(a), b, tp.make_mesh(4, device="cpu"),
                ct.SolverConfig(**HFORM), local_engine="pallas").iters
            print(f"hform-ulp R={r} b seed {seed}: {got}", flush=True)
            for key, v in got.items():
                pooled.setdefault(key, []).append(v)
        one = pooled["jax", "one device"]
        print(f"hform-ulp R={r} over {k} b: " + "; ".join(
            f"{p} {n}: {min(v)}..{max(v)}" for (p, n), v in pooled.items())
            + f"; the JAX package's 4-shard count from its one-device count:"
            f" up to {max(abs(x - o) for x, o in zip(pooled['jax', 4], one))}"
            f" of {min(one)}..{max(one)}", flush=True)
    elif mode == "stencil":
        for r in sizes:
            report(f"stencil R={r} n={r * 100}",
                   counts(grid_laplacian(r, 100), FLAGSHIP, "stencil",
                          engine="stencil"))
    elif mode == "shuffled":
        side, k = sizes
        g = grid_laplacian(side, side)
        for seed in range(k):
            a = jreorder.permute_csr(g, np.random.default_rng(seed)
                                     .permutation(g.n).astype(np.int64))
            report(f"shuffled {side}^2 seed {seed} jacobi", counts(
                a, dict(HFORM, precond="jacobi"), None, shards=(4,)))
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
