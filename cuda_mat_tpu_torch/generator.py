"""Random system generator — the equivalent of the reference's side-module
generator binary (reference bicstab_omp/generator.cpp); counterpart of
:mod:`cuda_mat_tpu.generator`, the same flags and, for one seed and config,
the same output bytes.

The reference reads one config line from stdin: ``mat_vec dim min max
probability_of_zero`` (1 = matrix, 0 = vector; see bicstab_omp/in_gen.txt
"0 100000 -10 10 0.999") and writes its custom text format to stdout
(generator.cpp:37-46, :51-56).  This tool accepts the same stdin config or
explicit flags, and can emit either the custom text formats or Matrix Market.

Usage::

    echo "0 100000 -10 10 0.999" | python -m cuda_mat_tpu_torch.generator > vec.txt
    python -m cuda_mat_tpu_torch.generator --kind matrix --dim 1000 \\
        --zero-prob 0.99 --min 1 --max 10 --mm -o mat.mtx
    python -m cuda_mat_tpu_torch.generator --kind laplacian --side 100 --mm -o lap.mtx
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cuda_mat_tpu_torch.generator")
    p.add_argument("--kind", choices=["matrix", "vector", "laplacian"],
                   default=None,
                   help="what to generate (default: read the reference's "
                        "stdin config line)")
    p.add_argument("--dim", type=int, default=1000)
    p.add_argument("--side", type=int, default=100,
                   help="grid side for --kind laplacian (n = side^2)")
    p.add_argument("--zero-prob", type=float, default=0.99)
    p.add_argument("--min", dest="vmin", type=float, default=-10.0)
    p.add_argument("--max", dest="vmax", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mm", action="store_true",
                   help="emit Matrix Market instead of the custom text format")
    p.add_argument("-o", "--output", default=None, help="default: stdout")
    args = p.parse_args(argv)

    if args.kind is None:
        # reference stdin config: mat_vec dim1 min max probability_of_zero
        # (generator.cpp:58-67)
        tok = sys.stdin.read().split()
        if len(tok) < 5:
            print("stdin config: <mat_vec> <dim> <min> <max> <p_zero>",
                  file=sys.stderr)
            return 1
        args.kind = "matrix" if int(tok[0]) else "vector"
        args.dim = int(tok[1])
        args.vmin, args.vmax = float(tok[2]), float(tok[3])
        args.zero_prob = float(tok[4])

    from cuda_mat_tpu_torch.io import omp_format
    from cuda_mat_tpu_torch.io.mmio import write_mm, write_mm_dense_vector
    from cuda_mat_tpu_torch.models.problems import (banded_laplacian,
                                                    gen_rand_csr_matrix,
                                                    gen_rand_vector)

    out = args.output
    if args.kind == "vector":
        v = gen_rand_vector(args.dim, args.zero_prob, args.vmin, args.vmax,
                            seed=args.seed)
        if args.mm:
            write_mm_dense_vector(out or sys.stdout, v)
        elif out:
            omp_format.write_vector(out, v)
        else:
            sys.stdout.write(omp_format.vector_text(v))
        return 0

    if args.kind == "laplacian":
        a = banded_laplacian(args.side)
    else:
        a = gen_rand_csr_matrix(args.dim, args.dim, args.zero_prob, args.vmin,
                                args.vmax, eps=1e-2, seed=args.seed)
    if args.mm:
        write_mm(out or sys.stdout, a)
    elif out:
        omp_format.write_matrix(out, a)
    else:
        sys.stdout.write(omp_format.matrix_text(a))
    return 0


if __name__ == "__main__":
    sys.exit(main())
