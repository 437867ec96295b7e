"""SNR-curve study: polar (N=1024) against LDPC (n=1008) at rates
0.50 / 0.67 / 0.75 / 0.83 over SNR −2..5 dB, with the SNR each rate needs for
BER 1e-3 and 1e-5 and the polar − LDPC gap.  Writes ``polar_results.json``,
``ldpc_results.json`` and ``snr_analysis.json`` (and plots unless
``--skip-plots``) to ``--output-dir``.

Example:
    python -m polarcode_and_ldpc_tpu_torch.cli.snr_curves --num-frames 100 \
        --output-dir results/snr_curves
    python -m polarcode_and_ldpc_tpu_torch.cli.snr_curves --device cpu \
        --polar-n 64 --ldpc-n 96 --rates 0.5 --skip-plots
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ._common import add_common_args, check_common_args, parse_snr_range


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--polar-n", type=int, default=1024)
    p.add_argument("--ldpc-n", type=int, default=1008)
    p.add_argument("--rates", default="0.50,0.67,0.75,0.83")
    p.add_argument("--snr-range", default="-2:5:1")
    p.add_argument("--num-frames", type=int, default=100)
    p.add_argument("--max-errors", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--polar-algorithm", default="sc", choices=["sc", "scl", "ca_scl"],
                   help="polar decoder for the study (ca_scl = flagship)")
    p.add_argument("--list-size", type=int, default=8)
    p.add_argument("--skip-plots", action="store_true")
    p.add_argument("--skip-polar", action="store_true",
                   help="reuse an existing polar_results.json in output-dir")
    p.add_argument("--skip-ldpc", action="store_true",
                   help="reuse an existing ldpc_results.json in output-dir")
    p.add_argument("--scl-body", default=None, choices=["torch", "cuda"],
                   help="chunk body of the plain list control (default: the device's)")
    p.add_argument("--scl-control", default=None,
                   choices=["split", "fused", "kernel", "unroll-fused", "unroll-kernel", "mega"],
                   help="list-decode control (default: unroll-kernel on a CUDA device, "
                        "unroll-fused on the CPU)")
    p.add_argument("--scl-chunk", type=int, default=128)
    p.add_argument("--scl-node-mode", default="exact", choices=["exact", "fast"],
                   help="fast = SSCL fast list nodes (approximate serving mode; error rates "
                        "match exact statistically)")
    p.add_argument("--chunks-per-dispatch", type=int, default=1)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    check_common_args(args)

    from ..core.config import SimulationConfig
    from ..sim.experiments import analyze_snr_requirements, test_multiple_rates
    from ..utils import plot_ber_curves, save_results

    rates = [float(r) for r in args.rates.split(",")]
    start, stop, step = parse_snr_range(args.snr_range)
    sim = SimulationConfig(snr_start=start, snr_stop=stop, snr_step=step,
                           num_frames=args.num_frames, max_errors=args.max_errors,
                           batch_size=args.batch_size, seed=args.seed,
                           chunks_per_dispatch=args.chunks_per_dispatch)
    polar_perf = {"scl_body_impl": args.scl_body, "scl_chunk": args.scl_chunk,
                  "scl_control_impl": args.scl_control, "scl_node_mode": args.scl_node_mode}
    outdir = Path(args.output_dir)

    if args.skip_polar:
        polar = json.loads((outdir / "polar_results.json").read_text())
    else:
        print(f"Polar N={args.polar_n}, rates {rates}:")
        polar = test_multiple_rates("polar", rates, N=args.polar_n, sim=sim, verbose=True,
                                    algorithm=args.polar_algorithm, list_size=args.list_size,
                                    polar_perf=polar_perf, device=args.device)
        save_results(polar, outdir / "polar_results.json")
    if args.skip_ldpc:
        ldpc = json.loads((outdir / "ldpc_results.json").read_text())
    else:
        print(f"LDPC n={args.ldpc_n}, rates {rates}:")
        ldpc = test_multiple_rates("ldpc", rates, N=args.ldpc_n, sim=sim, verbose=True,
                                   device=args.device)
        save_results(ldpc, outdir / "ldpc_results.json")

    # the SNR each rate needs, and the polar − LDPC gap
    analysis: dict = {}
    pa = analyze_snr_requirements(polar["self"])
    la = analyze_snr_requirements(ldpc["self"])
    for key in pa:
        analysis[key] = {}
        for rate in pa[key]:
            p_req, l_req = pa[key][rate], la[key].get(rate)
            analysis[key][rate] = {
                "polar_snr": p_req, "ldpc_snr": l_req,
                "snr_gap": (p_req - l_req if p_req is not None and l_req is not None else None),
            }
    save_results(analysis, outdir / "snr_analysis.json")

    if not args.skip_plots:
        snrs = sim.snr_points()
        plot_ber_curves(snrs, {f"polar r={r}": polar["self"][r]["ber"] for r in polar["self"]},
                        title=f"Polar N={args.polar_n} BER vs SNR",
                        filepath=outdir / "polar_ber_curves.png")
        plot_ber_curves(snrs, {f"ldpc r={r}": ldpc["self"][r]["ber"] for r in ldpc["self"]},
                        title=f"LDPC n={args.ldpc_n} BER vs SNR",
                        filepath=outdir / "ldpc_ber_curves.png")
        for r in polar["self"]:
            curves = {"polar": polar["self"][r]["ber"]}
            if r in ldpc["self"]:
                curves["ldpc"] = ldpc["self"][r]["ber"]
            plot_ber_curves(snrs, curves, title=f"BER vs SNR, rate {r}",
                            filepath=outdir / f"rate_{r}_ber.png")

    print(f"Done → {outdir}/")
    return {"polar": polar, "ldpc": ldpc, "analysis": analysis}


if __name__ == "__main__":
    main()
