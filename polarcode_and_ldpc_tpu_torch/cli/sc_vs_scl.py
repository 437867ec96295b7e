"""SC against SCL: ``--mode quick`` compares SC and SCL at each list size at
one SNR; ``--mode full`` sweeps an SNR range per list size and adds each
decoder's latency per frame (the throughput probe) and the figures.  Writes
``quick_results.json`` or ``results.json`` to ``--output-dir``.

Example:
    python -m polarcode_and_ldpc_tpu_torch.cli.sc_vs_scl --mode full \
        --list-sizes 1,2,4,8,16 --snr-range -2:3:1
    python -m polarcode_and_ldpc_tpu_torch.cli.sc_vs_scl --device cpu --N 32 --K 16 \
        --list-sizes 1,2 --num-frames 256 --skip-plots
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ._common import add_common_args, run_cli, parse_snr_range


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--mode", choices=["quick", "full"], default="quick")
    p.add_argument("--N", type=int, default=128)
    p.add_argument("--K", type=int, default=64)
    p.add_argument("--list-sizes", default="1,2,4,8,16")
    p.add_argument("--snr-db", type=float, default=1.0, help="quick-mode SNR")
    p.add_argument("--snr-range", default="-2:3:1", help="full-mode sweep")
    p.add_argument("--num-frames", type=int, default=1000)
    p.add_argument("--max-errors", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--use-crc", action="store_true", help="CA-SCL variants")
    p.add_argument("--skip-plots", action="store_true")
    return p


def _measure_latency(N, K, list_sizes, batch, device):
    from ..sim.throughput import measure_polar_throughput

    lat = {"sc": measure_polar_throughput(N=N, K=K, decoder="sc", batch=batch,
                                          device=device)["decode_ms_per_frame"]}
    for L in list_sizes:
        lat[str(L)] = measure_polar_throughput(N=N, K=K, decoder="scl", list_size=L,
                                               batch=batch, device=device)["decode_ms_per_frame"]
    return lat


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return run_cli("sc_vs_scl", args, argv, _main)


def _main(args, mesh) -> dict:
    from ..core.config import SimulationConfig
    from ..models.polar.construction import construct_polar_code
    from ..sim import MonteCarloSimulator, make_polar_pipeline, run_snr_sweep
    from ..utils import plot_ber_curves, plot_comparison, save_results

    N, K, dev = args.N, args.K, args.device
    list_sizes = [int(x) for x in args.list_sizes.split(",")]
    frozen, _ = construct_polar_code(N, K, "bhattacharyya", 2.0)
    outdir = Path(args.output_dir)
    decoder = "ca-scl" if args.use_crc else "scl"
    k_counted = K - 8 if args.use_crc else K

    if args.mode == "quick":
        results: dict = {"mode": "quick", "N": N, "K": K, "snr_db": args.snr_db}
        step = make_polar_pipeline(N, K, frozen, args.snr_db, decoder="sc", device=dev)
        res = MonteCarloSimulator(step, K, chunk_frames=args.batch_size, mesh=mesh).run(
            args.num_frames, max_errors=args.max_errors, seed=args.seed)
        results["sc"] = res.to_dict()
        print(f"SC:      BER {res.ber:.3e}  FER {res.fer:.3e}")
        for L in list_sizes:
            step = make_polar_pipeline(N, K, frozen, args.snr_db, decoder=decoder,
                                       list_size=L, device=dev)
            res = MonteCarloSimulator(step, k_counted, chunk_frames=args.batch_size,
                                      mesh=mesh).run(
                args.num_frames, max_errors=args.max_errors, seed=args.seed)
            results[f"scl_{L}"] = res.to_dict()
            print(f"SCL-{L:<3}: BER {res.ber:.3e}  FER {res.fer:.3e}")
        if args.main_rank:
            save_results(results, outdir / "quick_results.json")
        return results

    start, stop, step_db = parse_snr_range(args.snr_range)
    sim = SimulationConfig(snr_start=start, snr_stop=stop, snr_step=step_db,
                           num_frames=args.num_frames, max_errors=args.max_errors,
                           batch_size=args.batch_size, seed=args.seed)
    snrs = sim.snr_points()
    results = {"mode": "full", "N": N, "K": K, "snr_db": snrs, "curves": {}}
    print("SC:")
    results["curves"]["sc"] = run_snr_sweep(
        lambda s: make_polar_pipeline(N, K, frozen, s, decoder="sc", device=dev), K, snrs,
        sim.num_frames, sim.max_errors, sim.seed, sim.batch_size, mesh, verbose=True)
    for L in list_sizes:
        print(f"SCL-{L}:")
        results["curves"][f"scl_{L}"] = run_snr_sweep(
            lambda s, L=L: make_polar_pipeline(N, K, frozen, s, decoder=decoder, list_size=L,
                                               device=dev),
            k_counted, snrs, sim.num_frames, sim.max_errors, sim.seed, sim.batch_size, mesh,
            verbose=True)

    print("Latency:")
    results["latency_ms_per_frame"] = _measure_latency(N, K, list_sizes, args.batch_size, dev)
    for name, ms in results["latency_ms_per_frame"].items():
        print(f"  {name}: {ms:.4f} ms/frame")

    if args.main_rank:
        save_results(results, outdir / "results.json")
    if args.main_rank and not args.skip_plots:
        curves = results["curves"]
        plot_ber_curves(snrs, {k: v["ber"] for k, v in curves.items()},
                        title=f"SC vs SCL BER, N={N} K={K}",
                        filepath=outdir / "ber_comparison.png")
        plot_ber_curves(snrs, {k: v["fer"] for k, v in curves.items()},
                        title=f"SC vs SCL FER, N={N} K={K}", ylabel="FER",
                        filepath=outdir / "fer_comparison.png")
        lat = results["latency_ms_per_frame"]
        plot_comparison(list(lat.keys()), {"ms/frame": list(lat.values())},
                        title="Decode latency", ylabel="ms per frame",
                        filepath=outdir / "latency.png", log_scale=True)
        plot_improvement_summary(results, outdir / "improvement_comparison.png")
    print(f"Done → {outdir}/")
    return results


def plot_improvement_summary(results: dict, filepath) -> None:
    """Per list size, the FER reduction against SC in %, clamped to [0, 100],
    zero where SC itself made no error."""
    from ..utils.visualization import _get_pyplot

    plt = _get_pyplot()
    snrs = results["snr_db"]
    sc_fer = results["curves"]["sc"]["fer"]
    fig, ax = plt.subplots(figsize=(12, 7))
    for name, curve in results["curves"].items():
        if not name.startswith("scl_"):
            continue
        impr = [max(0.0, (s - f) / s * 100.0) if s > 0 else 0.0
                for s, f in zip(sc_fer, curve["fer"])]
        ax.plot(snrs, impr, "s-", linewidth=2.5, markersize=7,
                label=f"L={name.split('_')[1]}", alpha=0.85)
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("FER Improvement vs SC (%)")
    ax.set_title(f"Performance Gain of SCL over SC (N={results['N']}, K={results['K']})")
    ax.grid(True, alpha=0.3, linestyle="--")
    ax.legend(loc="best", ncol=2)
    ax.set_ylim([-5, 105])
    fig.tight_layout()
    fig.savefig(filepath, dpi=150)
    plt.close(fig)


if __name__ == "__main__":
    main()
