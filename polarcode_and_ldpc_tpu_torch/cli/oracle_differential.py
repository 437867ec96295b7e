"""Oracle differential: decode codes CONSTRUCTED by the third-party oracle
algorithms and overlay their BER/FER curves on those of the package's own
constructions — the reference's acceptance experiment.

The construction artifacts come from ``oracle.oracle_polar_frozen_set`` /
``oracle.oracle_ldpc_matrices``: the real libraries where they import, the
NumPy reimplementations of their published algorithms otherwise
(``oracle/constructions_np.py``).  Encode, channel and decode of BOTH arms
run through this package's pipelines on ``--device`` (by default the card:
SCL-8 at N=1024 through the list kernels, BP at n=504 through the LDPC
kernel).  Writes ``oracle_differential.json`` (and a figure unless
``--skip-plots``) to ``--output-dir``.

Example:
    python -m polarcode_and_ldpc_tpu_torch.cli.oracle_differential \
        --num-frames 20000 --output-dir results/oracle_differential
    python -m polarcode_and_ldpc_tpu_torch.cli.oracle_differential --device cpu \
        --num-frames 128 --snr-range 2:3:1 --polar-n 64 --polar-k 32 --ldpc-n 24 \
        --ldpc-k 12 --dv 2 --dc 4 --skip-plots
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from ._common import add_common_args, parse_snr_range, run_cli


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.set_defaults(output_dir="results/oracle_differential")
    p.add_argument("--polar-n", type=int, default=1024)
    p.add_argument("--polar-k", type=int, default=512)
    p.add_argument("--design-snr-db", type=float, default=2.0)
    p.add_argument("--polar-decoder", default="scl", choices=["sc", "scl", "ca_scl"])
    p.add_argument("--list-size", type=int, default=8)
    p.add_argument("--ldpc-n", type=int, default=504)
    p.add_argument("--ldpc-k", type=int, default=252)
    p.add_argument("--dv", type=int, default=3)
    p.add_argument("--dc", type=int, default=6)
    p.add_argument("--ldpc-seed", type=int, default=42)
    p.add_argument("--snr-range", default="0:4:0.5")
    p.add_argument("--num-frames", type=int, default=20000)
    p.add_argument("--max-errors", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--skip-plots", action="store_true")
    return p


def _gap_stats(self_curve: dict, oracle_curve: dict) -> dict:
    """Max |log10 BER| gap over the SNR points where both arms still measure
    errors — the overlay's acceptance metric."""
    gaps = []
    for s, b_s, b_o in zip(self_curve["snr_db"], self_curve["ber"], oracle_curve["ber"]):
        if b_s > 0 and b_o > 0:
            gaps.append({"snr_db": s, "log10_ber_gap": float(np.log10(b_s) - np.log10(b_o))})
    worst = max((abs(g["log10_ber_gap"]) for g in gaps), default=0.0)
    return {"per_point": gaps, "max_abs_log10_ber_gap": worst}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run_cli("oracle_differential", args, argv, _main)
    return 0


def _main(args, mesh) -> dict:
    from ..core.config import LDPCCodeConfig, PolarCodeConfig, SimulationConfig
    from ..models.polar.construction import construct_polar_code
    from ..oracle import oracle_ldpc_matrices, oracle_polar_frozen_set
    from ..sim.experiments import simulate_ldpc, simulate_polar
    from ..sim.pipelines import make_ldpc_pipeline
    from ..sim.sweep import run_snr_sweep

    out_dir = Path(args.output_dir)
    dev = args.device
    start, stop, step = parse_snr_range(args.snr_range)
    sim = SimulationConfig(snr_start=start, snr_stop=stop, snr_step=step,
                           num_frames=args.num_frames, max_errors=args.max_errors,
                           batch_size=args.batch_size, seed=args.seed)
    snrs = sim.snr_points()
    results: dict = {"snr_db": snrs, "num_frames": args.num_frames}

    # ---- polar arm: self construction vs oracle frozen set -------------------
    pcfg = PolarCodeConfig(N=args.polar_n, K=args.polar_k, construction="bhattacharyya",
                           design_snr_db=args.design_snr_db, algorithm=args.polar_decoder,
                           list_size=args.list_size)
    frozen_self, _ = construct_polar_code(pcfg.N, pcfg.K, pcfg.construction, pcfg.design_snr_db,
                                          device=dev)
    frozen_orc, backend = oracle_polar_frozen_set(pcfg.N, pcfg.K, args.design_snr_db)
    overlap = len(np.intersect1d(frozen_self, frozen_orc))
    print(f"polar frozen-set overlap self∩oracle: {overlap}/{len(frozen_self)}"
          f" (oracle backend: {backend})", flush=True)
    t0 = time.time()
    r_self = simulate_polar(pcfg, sim, mesh, verbose=True, device=dev)
    r_orc = simulate_polar(pcfg, sim, mesh, verbose=True, frozen=frozen_orc, device=dev)
    r_orc["config"]["construction"] = f"oracle:{backend}"
    results["polar"] = {
        "self": r_self, "oracle": r_orc,
        "oracle_backend": backend,
        "frozen_overlap": overlap,
        "gap": _gap_stats(r_self, r_orc),
        "elapsed_s": round(time.time() - t0, 1),
    }
    print(f"polar max |log10 BER| gap: {results['polar']['gap']['max_abs_log10_ber_gap']:.3f}",
          flush=True)

    # ---- LDPC arm: self H/G vs oracle (pyldpc-algorithm) H/G -----------------
    lcfg = LDPCCodeConfig(n=args.ldpc_n, k=args.ldpc_k, dv=args.dv, dc=args.dc,
                          seed=args.ldpc_seed, algorithm="bp")
    t0 = time.time()
    r_lself = simulate_ldpc(lcfg, sim, mesh, verbose=True, device=dev)
    H_o, G_o, lbackend = oracle_ldpc_matrices(args.ldpc_n, args.dv, args.dc, args.ldpc_seed)
    k_actual = G_o.shape[1]
    print(f"ldpc oracle backend: {lbackend}, k_actual={k_actual} (requested {args.ldpc_k})",
          flush=True)

    def builder(snr_db):
        return make_ldpc_pipeline(H_o, G_o.T % 2, snr_db, decoder="bp",
                                  max_iter=lcfg.max_iterations, early_stop=lcfg.early_stop,
                                  message_idx=np.arange(k_actual, dtype=np.int64),
                                  bp_impl=lcfg.bp_impl, device=dev)

    r_lorc = run_snr_sweep(builder, k_actual, snrs, num_frames=sim.num_frames,
                           max_errors=sim.max_errors, seed=sim.seed,
                           chunk_frames=sim.batch_size, mesh=mesh, verbose=True)
    r_lorc["config"] = {"n": args.ldpc_n, "k": k_actual, "rate": k_actual / args.ldpc_n,
                        "dv": args.dv, "dc": args.dc, "decoder": "bp",
                        "construction": f"oracle:{lbackend}"}
    results["ldpc"] = {
        "self": r_lself, "oracle": r_lorc,
        "oracle_backend": lbackend, "k_actual": k_actual,
        "gap": _gap_stats(r_lself, r_lorc),
        "elapsed_s": round(time.time() - t0, 1),
    }
    print(f"ldpc max |log10 BER| gap: {results['ldpc']['gap']['max_abs_log10_ber_gap']:.3f}",
          flush=True)

    if args.main_rank:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "oracle_differential.json").write_text(json.dumps(results, indent=2))
        if not args.skip_plots:
            _plot(results, out_dir)
    print(f"wrote {out_dir}/oracle_differential.json", flush=True)
    return results


def _plot(results: dict, out_dir: Path) -> None:
    from ..utils.visualization import _get_pyplot

    plt = _get_pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    for ax, fam, title in ((axes[0], "polar", "Polar (self vs oracle construction)"),
                           (axes[1], "ldpc", "LDPC (self vs oracle construction)")):
        for arm, style in (("self", "o-"), ("oracle", "s--")):
            c = results[fam][arm]
            snr = c["snr_db"]
            ber = [b if b > 0 else np.nan for b in c["ber"]]
            ax.semilogy(snr, ber, style, label=f"{arm} BER")
            fer = [f if f > 0 else np.nan for f in c["fer"]]
            ax.semilogy(snr, fer, style, alpha=0.4, label=f"{arm} FER")
        ax.set_title(title)
        ax.set_xlabel("SNR (dB)")
        ax.set_ylabel("error rate")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend()
    fig.tight_layout()
    fig.savefig(out_dir / "oracle_differential.png", dpi=130)
    plt.close(fig)


if __name__ == "__main__":
    raise SystemExit(main())
