"""High-level experiments as importable functions: BER/FER curves of one
polar or LDPC configuration, rate sweeps, and the SNR each rate needs.

Each experiment builds runtime-SNR Monte-Carlo pipelines (``sim.pipelines``),
runs them through ``sim.sweep.run_snr_sweep`` and returns the JAX package's
result dicts, so its plots and analyses read either package's output.
Everything runs on ``device`` (default ``"cuda"``); ``mesh=`` shards each
curve's frames over the ranks of a ``DeviceMesh`` (``parallel``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.config import ChannelConfig, LDPCCodeConfig, PolarCodeConfig, SimulationConfig
from ..models.ldpc.encoder import LDPCEncoder
from ..models.polar.construction import construct_polar_code
from .pipelines import make_channel_fn, make_ldpc_pipeline, make_polar_pipeline
from .sweep import run_snr_sweep


def _polar_decoder_name(cfg: PolarCodeConfig) -> str:
    return {"sc": "sc", "scl": "scl", "ca_scl": "ca-scl",
            "ca-scl": "ca-scl"}[cfg.algorithm]


def _channel_builder(channel: Optional[ChannelConfig]):
    """snr_db → channel_fn for the configured channel kind (None → AWGN)."""
    if channel is None or channel.kind == "awgn":
        return lambda snr: None  # the pipelines default to AWGN at that SNR
    return lambda snr: make_channel_fn(channel.kind, snr_db=snr,
                                       crossover_prob=channel.crossover_prob,
                                       k_factor=channel.k_factor)


def simulate_polar(
    cfg: PolarCodeConfig,
    sim: SimulationConfig,
    mesh=None,
    verbose: bool = False,
    channel: Optional[ChannelConfig] = None,
    frozen: Optional[np.ndarray] = None,
    device="cuda",
) -> dict:
    """Polar BER/FER curve over ``sim.snr_points()`` on ``channel`` (AWGN by
    default).  ``frozen`` overrides the construction with an explicit frozen
    set."""
    if frozen is None:
        frozen, _ = construct_polar_code(cfg.N, cfg.K, cfg.construction, cfg.design_snr_db,
                                         device=device)
    decoder = _polar_decoder_name(cfg)
    use_crc = cfg.use_crc or decoder == "ca-scl"
    chan = _channel_builder(channel)

    def builder(snr_db):
        return make_polar_pipeline(
            cfg.N, cfg.K, frozen, snr_db, decoder=decoder, list_size=cfg.list_size,
            use_crc=use_crc, crc_polynomial=cfg.crc_polynomial, channel_fn=chan(snr_db),
            scl_body_impl=cfg.scl_body_impl, scl_chunk=cfg.scl_chunk,
            scl_control_impl=cfg.scl_control_impl, scl_node_mode=cfg.scl_node_mode,
            device=device)

    k_counted = cfg.K - (int(cfg.crc_polynomial.split("-")[1]) if use_crc else 0)
    out = run_snr_sweep(builder, k_counted, sim.snr_points(), num_frames=sim.num_frames,
                        max_errors=sim.max_errors, seed=sim.seed, chunk_frames=sim.batch_size,
                        mesh=mesh, verbose=verbose, chunks_per_dispatch=sim.chunks_per_dispatch)
    out["config"] = {"N": cfg.N, "K": cfg.K, "rate": cfg.rate, "decoder": decoder,
                     "list_size": cfg.list_size, "use_crc": use_crc,
                     "construction": cfg.construction}
    return out


def simulate_ldpc(
    cfg: LDPCCodeConfig,
    sim: SimulationConfig,
    mesh=None,
    verbose: bool = False,
    H: Optional[np.ndarray] = None,
    channel: Optional[ChannelConfig] = None,
    device="cuda",
) -> dict:
    """LDPC BER/FER curve over ``sim.snr_points()`` on ``channel`` (AWGN by
    default)."""
    enc = LDPCEncoder(cfg.n, cfg.k, H=H, dv=cfg.dv, dc=cfg.dc, seed=cfg.seed,
                      method=cfg.construction, device=device)
    decoder = {"bp": "bp", "min_sum": "ms", "ms": "ms", "nms": "nms",
               "oms": "oms"}[cfg.algorithm]
    norm = cfg.normalization if decoder in ("ms", "nms") else 1.0
    offset = cfg.offset if decoder == "oms" else 0.0
    chan = _channel_builder(channel)

    def builder(snr_db):
        return make_ldpc_pipeline(
            enc.H, enc.G, snr_db, decoder=decoder, max_iter=cfg.max_iterations,
            normalization=norm, offset=offset, early_stop=cfg.early_stop,
            message_idx=enc.info_positions, channel_fn=chan(snr_db), bp_impl=cfg.bp_impl,
            device=device)

    out = run_snr_sweep(builder, enc.k, sim.snr_points(), num_frames=sim.num_frames,
                        max_errors=sim.max_errors, seed=sim.seed, chunk_frames=sim.batch_size,
                        mesh=mesh, verbose=verbose, chunks_per_dispatch=sim.chunks_per_dispatch)
    out["config"] = {"n": cfg.n, "k": enc.k, "rate": enc.k / cfg.n, "dv": cfg.dv,
                     "dc": cfg.dc, "decoder": decoder, "max_iterations": cfg.max_iterations}
    return out


def run_ber_simulation(
    polar_cfg: Optional[PolarCodeConfig] = None,
    ldpc_cfg: Optional[LDPCCodeConfig] = None,
    sim: Optional[SimulationConfig] = None,
    mesh=None,
    use_oracle: bool = False,
    verbose: bool = False,
    channel: Optional[ChannelConfig] = None,
    device="cuda",
) -> dict:
    """Combined polar + LDPC BER study: ``{"snr_range", "polar": {"self"},
    "ldpc": {"self"}}``.  ``use_oracle`` adds the third-party library curves
    (``"library"``, sequential NumPy on the host) where ``polarcodes`` /
    ``pyldpc`` import; without them the result is that of
    ``use_oracle=False``."""
    sim = sim or SimulationConfig()
    results: dict = {"snr_range": sim.snr_points()}
    if polar_cfg is not None:
        if verbose:
            print(f"Polar N={polar_cfg.N} K={polar_cfg.K} ({_polar_decoder_name(polar_cfg)}):")
        results["polar"] = {"self": simulate_polar(polar_cfg, sim, mesh, verbose,
                                                   channel=channel, device=device)}
    if ldpc_cfg is not None:
        if verbose:
            print(f"LDPC n={ldpc_cfg.n} k={ldpc_cfg.k} ({ldpc_cfg.algorithm}):")
        results["ldpc"] = {"self": simulate_ldpc(ldpc_cfg, sim, mesh, verbose,
                                                 channel=channel, device=device)}
    if use_oracle:
        from ..oracle import oracle_available

        if oracle_available("polar") and polar_cfg is not None:
            from ..oracle.polar_oracle import simulate_polar_oracle

            results["polar"]["library"] = simulate_polar_oracle(polar_cfg, sim)
        if oracle_available("ldpc") and ldpc_cfg is not None:
            from ..oracle.ldpc_oracle import simulate_ldpc_oracle

            results["ldpc"]["library"] = simulate_ldpc_oracle(ldpc_cfg, sim)
    return results


def test_multiple_rates(
    family: str,
    rates: Sequence[float] = (0.5, 2 / 3, 0.75, 5 / 6),
    N: int = 1024,
    sim: Optional[SimulationConfig] = None,
    mesh=None,
    verbose: bool = False,
    algorithm: Optional[str] = None,
    list_size: int = 8,
    polar_perf: Optional[dict] = None,
    device="cuda",
) -> dict:
    """Rate sweep: one BER/FER curve per code rate, ``{"self": {"0.50":
    curve, ...}}``.

    ``algorithm`` selects the polar decoder (``sc`` by default; the list
    decoders take DE-GA constructions with rate-matched design SNRs) or the
    LDPC decoder (``bp`` by default).  ``polar_perf`` holds the list
    decoder's implementation fields of ``PolarCodeConfig`` (``scl_*``)."""
    sim = sim or SimulationConfig(snr_start=-2, snr_stop=5, snr_step=1,
                                  num_frames=100, max_errors=100)
    out: dict = {"self": {}}
    for rate in rates:
        label = f"{rate:.2f}"
        if family == "polar":
            K = int(round(N * rate))
            if (algorithm or "sc") in ("scl", "ca_scl", "ca-scl"):
                # high-rate codes polarize usefully only when designed near
                # their operating point
                construction, design = "dega", (
                    2.0 if rate <= 0.7 else 3.5 if rate <= 0.8 else 4.5)
            else:
                construction, design = "bhattacharyya", 2.0
            cfg = PolarCodeConfig(N=N, K=K, algorithm=algorithm or "sc", list_size=list_size,
                                  construction=construction, design_snr_db=design,
                                  **(polar_perf or {}))
            res = simulate_polar(cfg, sim, mesh, verbose, device=device)
        elif family == "ldpc":
            k = int(round(N * rate))
            # keep dv = 3; dc from the rate: dv·n = dc·m ⇒ dc = dv·n/(n−k)
            dc = max(4, int(round(3 * N / (N - k))))
            cfg = LDPCCodeConfig(n=N, k=k, dv=3, dc=dc, algorithm=algorithm or "bp")
            res = simulate_ldpc(cfg, sim, mesh, verbose, device=device)
        else:
            raise ValueError(f"unknown family {family!r}")
        if verbose:
            print(f"[{family} rate {label}] done")
        out["self"][label] = res
    return out


def analyze_snr_requirements(results_by_rate: dict,
                             target_bers: Sequence[float] = (1e-3, 1e-5)) -> dict:
    """First SNR whose BER is below each target, per rate."""
    analysis: dict = {}
    for target in target_bers:
        key = f"ber_{target:.0e}".replace("e-0", "e-")
        analysis[key] = {}
        for rate, res in results_by_rate.items():
            req = None
            for s, b in zip(res["snr_db"], res["ber"]):
                if b < target:
                    req = s
                    break
            analysis[key][rate] = req
    return analysis


def build_code(family: str, N: int, K: int, dv: int = 3, dc: int = 6, device="cuda"):
    """The code of one entry of a code-parameter sweep, built before anything
    decodes: ``(cfg, frozen)`` of an SC polar code (``PolarCodeConfig``'s
    construction) or ``(cfg, encoder)`` of a (dv, dc) LDPC code.  What the
    construction refuses raises ``ValueError`` or ``AssertionError`` here; the
    sweeps record those and nothing else."""
    if family == "polar":
        cfg = PolarCodeConfig(N=N, K=K, algorithm="sc")
        frozen, _ = construct_polar_code(cfg.N, cfg.K, cfg.construction, cfg.design_snr_db,
                                         device=device)
        return cfg, frozen
    cfg = LDPCCodeConfig(n=N, k=K, dv=dv, dc=dc)
    return cfg, LDPCEncoder(cfg.n, cfg.k, dv=cfg.dv, dc=cfg.dc, seed=cfg.seed,
                            method=cfg.construction, device=device)


def measure_code(family: str, cfg, code, sim: SimulationConfig, snr_db: float,
                 batch_size: int, mesh=None, sc_impl: Optional[str] = None,
                 device="cuda") -> tuple[dict, dict]:
    """One entry of a code-parameter sweep on a code of ``build_code``: its
    curve at ``sim``'s points and its throughput probe (a steady-state rate:
    warmed up, kernels built outside the clock; a sweep's first Monte-Carlo
    point also times building the kernels, so its rate is not a decode
    rate)."""
    from .throughput import measure_ldpc_throughput, measure_polar_throughput

    if family == "polar":
        curve = simulate_polar(cfg, sim, mesh, frozen=code, device=device)
        thpt = measure_polar_throughput(N=cfg.N, K=cfg.K, snr_db=snr_db, batch=batch_size,
                                        sc_impl=sc_impl, device=device)
    else:
        curve = simulate_ldpc(cfg, sim, mesh, H=code.H, device=device)
        thpt = measure_ldpc_throughput(n=cfg.n, k=cfg.k, dv=cfg.dv, dc=cfg.dc, snr_db=snr_db,
                                       batch=batch_size, H=code.H, device=device)
    return curve, thpt


def test_code_lengths(
    family: str,
    lengths: Sequence[int],
    rate: float = 0.5,
    snr_db: float = 3.0,
    num_frames: int = 256,
    batch_size: int = 256,
    mesh=None,
    sc_impl: Optional[str] = None,
    device="cuda",
) -> list[dict]:
    """Code-length sweep at a fixed rate: per length BER / FER at ``snr_db``
    and the throughput probe's encode / decode rates.

    An entry whose code cannot be built (``build_code``: a length that is not
    a power of 2 for polar codes, degrees that do not fit the LDPC length)
    records ``"error"`` and the sweep goes on; any other failure (a kernel's
    build or launch) raises.  ``sc_impl``: the SC decoder of the polar probe
    (``None``: the device's choice)."""
    out = []
    sim = SimulationConfig(snr_start=snr_db, snr_stop=snr_db, snr_step=1,
                           num_frames=num_frames, max_errors=None, batch_size=batch_size)
    for N in lengths:
        entry: dict = {"length": N, "rate": rate}
        try:
            cfg, code = build_code(family, N, int(N * rate), device=device)
        except (ValueError, AssertionError) as e:
            entry["error"] = str(e)
            out.append(entry)
            continue
        curve, thpt = measure_code(family, cfg, code, sim, snr_db, batch_size, mesh, sc_impl,
                                   device)
        entry.update(ber=curve["ber"][0], fer=curve["fer"][0],
                     encoding_throughput=thpt["encoding_throughput"],
                     decoding_throughput=thpt["decoding_throughput"],
                     decode_ms_per_frame=thpt["decode_ms_per_frame"])
        out.append(entry)
    return out
