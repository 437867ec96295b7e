"""Main benchmark CLI: BER / FER simulation of a polar and an LDPC code over
an SNR range and a channel, then the throughput probes and the complexity
counts.  Writes ``data/ber_simulation_results.json``,
``data/throughput_results.json``, ``data/complexity_results.json`` and
``benchmark_results.json`` (and BER / FER figures unless ``--skip-plots``) to
``--output-dir``.

Example:
    python -m polarcode_and_ldpc_tpu_torch.cli.run_benchmark \
        --snr-range -2:6:0.5 --num-frames 1000 --max-errors 100 --output-dir results
    python -m polarcode_and_ldpc_tpu_torch.cli.run_benchmark --channel rayleigh \
        --snr-range 0:6:2 --batch-size 4096 --skip-plots
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from ._common import add_common_args, run_cli, parse_snr_range


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--snr-range", default="-2:6:0.5", help="start:stop:step (dB)")
    p.add_argument("--num-frames", type=int, default=1000)
    p.add_argument("--max-errors", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=256, help="device frames per chunk")
    p.add_argument("--polar-config", default=None, help="YAML config path")
    p.add_argument("--ldpc-config", default=None, help="YAML config path")
    p.add_argument("--channel", default="awgn", choices=["awgn", "bsc", "rayleigh", "rician"])
    p.add_argument("--crossover-prob", type=float, default=0.1, help="BSC only")
    p.add_argument("--k-factor", type=float, default=1.0, help="Rician only")
    p.add_argument("--use-third-party", action="store_true",
                   help="overlay the third-party oracle curves (polarcodes / pyldpc), where "
                        "those libraries import")
    p.add_argument("--skip-polar", action="store_true")
    p.add_argument("--skip-ldpc", action="store_true")
    p.add_argument("--skip-throughput", action="store_true")
    p.add_argument("--skip-complexity", action="store_true")
    p.add_argument("--skip-plots", action="store_true")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return run_cli("run_benchmark", args, argv, _main)


def _main(args, mesh) -> dict:
    from ..core.config import (ChannelConfig, LDPCCodeConfig, PolarCodeConfig,
                               SimulationConfig, load_yaml_config)
    from ..sim.experiments import run_ber_simulation
    from ..utils import analyze_complexity, plot_ber_curves, save_results

    polar_cfg = (load_yaml_config(args.polar_config, PolarCodeConfig)
                 if args.polar_config else PolarCodeConfig())
    ldpc_cfg = (load_yaml_config(args.ldpc_config, LDPCCodeConfig)
                if args.ldpc_config else LDPCCodeConfig())
    start, stop, step = parse_snr_range(args.snr_range)
    sim = SimulationConfig(snr_start=start, snr_stop=stop, snr_step=step,
                           num_frames=args.num_frames, max_errors=args.max_errors,
                           batch_size=args.batch_size, seed=args.seed,
                           output_dir=args.output_dir)
    outdir = Path(args.output_dir)
    combined: dict = {"timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
                      "config": {"snr_range": args.snr_range, "num_frames": args.num_frames,
                                 "max_errors": args.max_errors}}

    t0 = time.perf_counter()
    channel = ChannelConfig(kind=args.channel, crossover_prob=args.crossover_prob,
                            k_factor=args.k_factor)
    ber = run_ber_simulation(None if args.skip_polar else polar_cfg,
                             None if args.skip_ldpc else ldpc_cfg, sim, mesh=mesh,
                             use_oracle=args.use_third_party, verbose=True, channel=channel,
                             device=args.device)
    combined["ber_simulation"] = ber
    if args.main_rank:
        save_results(ber, outdir / "data" / "ber_simulation_results.json")

    if args.main_rank and not args.skip_plots:
        curves_ber, curves_fer = {}, {}
        for fam in ("polar", "ldpc"):
            for impl in ("self", "library"):
                res = ber.get(fam, {}).get(impl)
                if res:
                    curves_ber[f"{fam} ({impl})"] = res["ber"]
                    curves_fer[f"{fam} ({impl})"] = res["fer"]
        if curves_ber:
            snrs = ber["snr_range"]
            plot_ber_curves(snrs, curves_ber, title="BER vs SNR",
                            filepath=outdir / "figures" / "ber_curves.png")
            plot_ber_curves(snrs, curves_fer, title="FER vs SNR", ylabel="FER",
                            filepath=outdir / "figures" / "fer_curves.png")

    if not args.skip_throughput:
        from ..sim.throughput import run_throughput_test

        print("Measuring throughput...")
        thpt = run_throughput_test(
            {"N": polar_cfg.N, "K": polar_cfg.K, "batch": args.batch_size},
            {"n": ldpc_cfg.n, "k": ldpc_cfg.k, "batch": args.batch_size,
             "max_iter": ldpc_cfg.max_iterations}, device=args.device)
        combined["throughput"] = thpt
        if args.main_rank:
            save_results(thpt, outdir / "data" / "throughput_results.json")
        print(f"  polar decode: {thpt['polar']['decoding_throughput']:.3f} Mbps, "
              f"ldpc decode: {thpt['ldpc']['decoding_throughput']:.3f} Mbps")

    if not args.skip_complexity:
        comp = analyze_complexity(
            {"N": polar_cfg.N, "K": polar_cfg.K, "list_size": polar_cfg.list_size},
            {"n": ldpc_cfg.n, "k": ldpc_cfg.k, "dv": ldpc_cfg.dv, "dc": ldpc_cfg.dc,
             "max_iterations": ldpc_cfg.max_iterations})
        combined["complexity"] = comp
        if args.main_rank:
            save_results(comp, outdir / "data" / "complexity_results.json")

    combined["elapsed_seconds"] = time.perf_counter() - t0
    if args.main_rank:
        save_results(combined, outdir / "benchmark_results.json")
    print(f"Done in {combined['elapsed_seconds']:.1f}s → {outdir}/")
    return combined


if __name__ == "__main__":
    main()
