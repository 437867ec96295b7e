"""Code-parameter sweeps: code length at rate 0.5, and code rate at a fixed
length, each entry with its BER / FER at ``--snr-db`` and the throughput
probe's decode rate.  Writes ``code_params_results.json`` to
``--output-dir``.

An entry whose code cannot be built (a polar length that is not a power of
2, LDPC degrees that do not fit) records ``"error"``; any other failure
raises.

Example:
    python -m polarcode_and_ldpc_tpu_torch.cli.code_params --families polar,ldpc
    python -m polarcode_and_ldpc_tpu_torch.cli.code_params --device cpu \
        --polar-lengths 32,64 --ldpc-lengths 48,96 --rates 0.5 --rate-length 64 \
        --num-frames 64 --batch-size 64
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ._common import add_common_args, run_cli


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--polar-lengths", default="128,256,512,1024,2048,4096")
    p.add_argument("--ldpc-lengths", default="126,252,504,1008,2016,4032")
    p.add_argument("--rates", default="0.25,0.33,0.5,0.67,0.75,0.875")
    p.add_argument("--rate-length", type=int, default=1024)
    p.add_argument("--snr-db", type=float, default=3.0)
    p.add_argument("--num-frames", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--families", default="polar,ldpc")
    p.add_argument("--skip-rates", action="store_true")
    p.add_argument("--skip-lengths", action="store_true")
    p.add_argument("--sc-impl", default=None, choices=["unrolled", "scan", "mega"],
                   help="polar SC implementation of the throughput probes (default: the "
                        "device's, the whole-decode kernel on a CUDA device)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return run_cli("code_params", args, argv, _main)


def _main(args, mesh) -> dict:
    from ..core.config import SimulationConfig
    from ..sim.experiments import build_code, measure_code, test_code_lengths
    from ..utils import save_results

    outdir = Path(args.output_dir)
    families = args.families.split(",")
    results: dict = {"length_tests": {}, "rate_tests": {}}

    if not args.skip_lengths:
        for fam in families:
            lengths = [int(x) for x in
                       (args.polar_lengths if fam == "polar" else args.ldpc_lengths).split(",")]
            print(f"{fam} length sweep {lengths} @ {args.snr_db} dB:")
            res = test_code_lengths(fam, lengths, rate=0.5, snr_db=args.snr_db,
                                    num_frames=args.num_frames, batch_size=args.batch_size,
                                    mesh=mesh, sc_impl=args.sc_impl, device=args.device)
            for e in res:
                print(f"  N={e['length']}: BER {e['ber']:.2e} "
                      f"dec {e['decoding_throughput']:.3f} Mbps" if "ber" in e
                      else f"  N={e['length']}: {e['error']}")
            results["length_tests"][fam] = res

    if not args.skip_rates:
        rates = [float(r) for r in args.rates.split(",")]
        N = args.rate_length
        sim = SimulationConfig(snr_start=args.snr_db, snr_stop=args.snr_db, snr_step=1,
                               num_frames=args.num_frames, max_errors=None,
                               batch_size=args.batch_size, seed=args.seed)
        for fam in families:
            out = []
            print(f"{fam} rate sweep {rates} @ N={N}, {args.snr_db} dB:")
            for rate in rates:
                entry: dict = {"rate": rate, "length": N}
                K = int(N * rate)
                # LDPC codes keep dv = 3 and take dc from the rate: dv·n = dc·m
                dc = max(4, int(round(3 * N / (N - K))))
                try:
                    cfg, code = build_code(fam, N, K, dc=dc, device=args.device)
                except (ValueError, AssertionError) as e:
                    entry["error"] = str(e)
                    print(f"  rate {rate}: ERROR {e}")
                    out.append(entry)
                    continue
                # the probe's steady-state decode rate, not the sweep's first
                # Monte-Carlo point, whose time includes building the kernels
                curve, thpt = measure_code(fam, cfg, code, sim, args.snr_db, args.batch_size,
                                           mesh=mesh, sc_impl=args.sc_impl, device=args.device)
                entry.update(ber=curve["ber"][0], fer=curve["fer"][0],
                             throughput_mbps=thpt["decoding_throughput"],
                             decode_ms_per_frame=thpt["decode_ms_per_frame"])
                print(f"  rate {rate}: BER {entry['ber']:.2e} "
                      f"dec {entry['throughput_mbps']:.1f} Mbps")
                out.append(entry)
            results["rate_tests"][fam] = out

    if args.main_rank:
        save_results(results, outdir / "code_params_results.json")
    print(f"Done → {outdir}/")
    return results


if __name__ == "__main__":
    main()
