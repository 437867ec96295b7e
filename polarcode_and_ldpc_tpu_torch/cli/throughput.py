"""Standalone throughput probe: encode / decode / end-to-end Mbit/s of a polar
code (SC or SCL) and an LDPC code (BP) on one batch.  Writes
``data/throughput_results.json`` to ``--output-dir``.

Example:
    python -m polarcode_and_ldpc_tpu_torch.cli.throughput --polar-n 1024 --batch 16384
    python -m polarcode_and_ldpc_tpu_torch.cli.throughput --device cpu --polar-n 64 \
        --ldpc-n 96 --ldpc-k 48 --batch 8
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ._common import add_common_args, run_cli


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--polar-n", type=int, default=1024)
    p.add_argument("--polar-k", type=int, default=512)
    p.add_argument("--polar-decoder", default="sc", choices=["sc", "scl"])
    p.add_argument("--sc-impl", default=None, choices=["unrolled", "scan", "mega"],
                   help="SC implementation (default: the device's, the whole-decode kernel "
                        "on a CUDA device); only applies to --polar-decoder sc")
    p.add_argument("--bp-impl", default=None, choices=["torch", "cuda", "xla", "pallas", "auto"],
                   help="BP implementation (default: the device's, the fused kernel on a CUDA "
                        "device; the JAX package's xla / pallas / auto mean the same)")
    p.add_argument("--list-size", type=int, default=8)
    p.add_argument("--ldpc-n", type=int, default=504)
    p.add_argument("--ldpc-k", type=int, default=252)
    p.add_argument("--max-iter", type=int, default=20)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--snr-db", type=float, default=3.0)
    p.add_argument("--skip-polar", action="store_true")
    p.add_argument("--skip-ldpc", action="store_true")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return run_cli("throughput", args, argv, _main)


def _main(args, mesh) -> dict:
    from ..sim.throughput import measure_ldpc_throughput, measure_polar_throughput
    from ..utils import save_results

    results: dict = {}
    if not args.skip_polar:
        results["polar"] = p = measure_polar_throughput(
            N=args.polar_n, K=args.polar_k, snr_db=args.snr_db, batch=args.batch,
            decoder=args.polar_decoder, list_size=args.list_size, seed=args.seed,
            sc_impl=args.sc_impl, device=args.device)
        print(f"Polar {args.polar_decoder.upper()} N={args.polar_n}: "
              f"enc {p['encoding_throughput']:.2f} / dec {p['decoding_throughput']:.2f} "
              f"/ e2e {p['end_to_end_throughput']:.2f} Mbps "
              f"({p['decode_ms_per_frame']:.4f} ms/frame)")
    if not args.skip_ldpc:
        results["ldpc"] = r = measure_ldpc_throughput(
            n=args.ldpc_n, k=args.ldpc_k, snr_db=args.snr_db, batch=args.batch,
            max_iter=args.max_iter, seed=args.seed, bp_impl=args.bp_impl, device=args.device)
        print(f"LDPC BP n={args.ldpc_n}: "
              f"enc {r['encoding_throughput']:.2f} / dec {r['decoding_throughput']:.2f} "
              f"/ e2e {r['end_to_end_throughput']:.2f} Mbps "
              f"({r['decode_ms_per_frame']:.4f} ms/frame)")
    if args.main_rank:
        save_results(results, Path(args.output_dir) / "data" / "throughput_results.json")
    return results


if __name__ == "__main__":
    main()
