"""rgb2spec_opt: sigmoid-polynomial RGB -> spectrum coefficient tables
(port of acceleratedvolrenderer_tpu/cli/rgb2spec_opt.py; pbrt
cmd/rgb2spec_opt.cpp, Jakob & Hanika 2019).

The whole lattice is one batched Levenberg-Marquardt fit
(utils/spectrum.fit_sigmoid_polynomial), every (max axis, z, y, x) point
a lane, on the CUDA card (--cpu: on the CPU).  The output is an .npz with
the (3, res, res, res, 3) coefficients and the lattice's metadata.

    python -m acceleratedvolrenderer_tpu_torch.cli.rgb2spec_opt 64 out.npz
"""
import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="avrt-torch-rgb2spec-opt")
    ap.add_argument("resolution", type=int)
    ap.add_argument("output")
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--cpu", action="store_true",
                    help="fit on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)

    import numpy as np

    from ..utils import spectrum as sp

    t0 = time.time()
    table = sp.make_rgb2spec_table(res=args.resolution, iters=args.iters,
                                   device="cpu" if args.cpu else None)
    np.savez_compressed(
        args.output, coeffs=table, resolution=args.resolution,
        lambda_min=sp.LAMBDA_MIN, lambda_max=sp.LAMBDA_MAX,
        layout="(max_axis, z=max_component, y, x, coeff) — coefficients in "
               "the nanometer domain for sigmoid_polynomial_eval")
    n = 3 * args.resolution ** 3
    print(f"fit {n} lattice points in {time.time() - t0:.1f}s -> "
          f"{args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
