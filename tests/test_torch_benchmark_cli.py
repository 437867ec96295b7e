"""The reference's benchmark front end in the port against the JAX package, on
the CPU: ``simulate_polar`` / ``simulate_ldpc`` over the BSC and fading
channels, the CLIs ``run_benchmark`` and ``throughput`` (``--device cpu``), the
throughput probes, the complexity counts and roofline, the metrics helpers and
the tracing utilities (the sweep CLIs ``code_params`` and ``sc_vs_scl`` are in
``test_torch_sweep_clis.py``).  Codes are tiny (polar N ≤ 64, LDPC n ≤ 96).

JAX runs with ``jax_enable_x64`` off (``with jax.enable_x64(False)``), as a
user runs it, so both packages draw the same 32-bit message bits and BSC
flips.  Curves are compared with ``same_curve`` (each point's frame errors
within one frame, at most 1 frame in 256 over a curve, bit errors equal where
the frame errors are); times and rates are each run's own and are not
compared, only their keys and that the rates are positive.
"""

import dataclasses
import json
import math
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from polarcode_and_ldpc_tpu.cli import run_benchmark as jrun_benchmark
from polarcode_and_ldpc_tpu.core import config as jcfg
from polarcode_and_ldpc_tpu.sim import experiments as jexp
from polarcode_and_ldpc_tpu.sim import throughput as jthpt
from polarcode_and_ldpc_tpu.utils import complexity as jcomplexity
from polarcode_and_ldpc_tpu.utils import metrics as jmetrics
from polarcode_and_ldpc_tpu_torch import utils as tutils
from polarcode_and_ldpc_tpu_torch.cli import run_benchmark as trun_benchmark
from polarcode_and_ldpc_tpu_torch.cli import throughput as tthroughput_cli
from polarcode_and_ldpc_tpu_torch.core import config as tcfg
from polarcode_and_ldpc_tpu_torch.sim import experiments as texp
from polarcode_and_ldpc_tpu_torch.sim import throughput as tthpt
from polarcode_and_ldpc_tpu_torch.utils import complexity as tcomplexity
from polarcode_and_ldpc_tpu_torch.utils import tracing as ttracing
from test_torch_snr_curves import same_curve


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's side, module fixtures included: many
    small ops cost a fraction on one thread of what waking torch's thread pool
    costs on a busy host, and the cores of the other test workers are left
    alone.  The count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


POLAR = dict(N=64, K=32)
LDPC = dict(n=96, k=48)


# -- Monte-Carlo curves over the other channels ----------------------------------------

@pytest.mark.parametrize("kind", ["bsc", "rayleigh", "rician"])
def test_simulate_over_channels_equals_jax(kind):
    """SC polar (N=64), CA-SCL-2 polar (N=32, CRC-8), BP LDPC (n=96), 256
    frames a point: BSC p = 0.08 at one point (it has no SNR), fading at two
    (one runtime-SNR step)."""
    spec = "1:1:1" if kind == "bsc" else "0:2:2"
    sim = dict(num_frames=256, max_errors=1000, batch_size=64, seed=3)
    chan = dict(kind=kind, crossover_prob=0.08, k_factor=2.0)
    cases = [("polar", dict(**POLAR, algorithm="sc")),
             ("polar", dict(N=32, K=16, algorithm="ca_scl", list_size=2, scl_chunk=16)),
             ("ldpc", dict(**LDPC, max_iterations=10))]
    for family, fields in cases:
        tsim = tcfg.SimulationConfig.from_range_string(spec, **sim)
        jsim = jcfg.SimulationConfig.from_range_string(spec, **sim)
        if family == "polar":
            got = texp.simulate_polar(tcfg.PolarCodeConfig(**fields), tsim,
                                      channel=tcfg.ChannelConfig(**chan), device="cpu")
            with jax.enable_x64(False):
                want = jexp.simulate_polar(jcfg.PolarCodeConfig(**fields), jsim,
                                           channel=jcfg.ChannelConfig(**chan))
        else:
            got = texp.simulate_ldpc(tcfg.LDPCCodeConfig(**fields), tsim,
                                     channel=tcfg.ChannelConfig(**chan), device="cpu")
            with jax.enable_x64(False):
                want = jexp.simulate_ldpc(jcfg.LDPCCodeConfig(**fields), jsim,
                                          channel=jcfg.ChannelConfig(**chan))
        same_curve(got, want)


def benchmark_argv(root):
    (root / "polar.yaml").write_text("N: 32\nK: 16\nalgorithm: ca_scl\nlist_size: 2\n"
                                     "scl_chunk: 16\n")
    (root / "ldpc.yaml").write_text("n: 96\nk: 48\nmax_iterations: 10\n")
    return ["--polar-config", str(root / "polar.yaml"), "--ldpc-config",
            str(root / "ldpc.yaml"), "--snr-range=0:2:2", "--num-frames", "256",
            "--max-errors", "1000", "--batch-size", "64", "--channel", "rayleigh",
            "--skip-throughput", "--skip-plots", "--seed", "5"]


@pytest.fixture(scope="module")
def benchmark_runs(tmp_path_factory):
    """``run_benchmark`` of each package, once: CA-SCL-2 polar N=32 and BP
    LDPC n=96 (YAML configs) over Rayleigh, two points, 256 frames each."""
    root = tmp_path_factory.mktemp("run_benchmark")
    argv = benchmark_argv(root)
    with jax.enable_x64(False):
        want = jrun_benchmark.main(argv + ["--output-dir", str(root / "jax")])
    got = trun_benchmark.main(argv + ["--output-dir", str(root / "port"), "--device", "cpu"])
    return root, got, want


def test_run_benchmark_equals_jax(benchmark_runs):
    root, got, want = benchmark_runs
    assert got.keys() == want.keys()
    assert got["config"] == want["config"] and got["complexity"] == want["complexity"]
    for family in ("polar", "ldpc"):
        same_curve(got["ber_simulation"][family]["self"], want["ber_simulation"][family]["self"])
    assert got["ber_simulation"]["polar"]["self"]["config"]["decoder"] == "ca-scl"
    names = lambda d: sorted(p.relative_to(d).as_posix() for p in d.rglob("*"))  # noqa: E731
    assert names(root / "port") == names(root / "jax")
    for name in ("benchmark_results.json", "data/ber_simulation_results.json",
                 "data/complexity_results.json"):
        t = json.loads((root / "port" / name).read_text())
        j = json.loads((root / "jax" / name).read_text())
        assert t.keys() == j.keys(), name
    assert not list((root / "port").rglob("*.png"))  # --skip-plots


def test_run_benchmark_flags(benchmark_runs, tmp_path):
    """The channel flags reach the simulation; the oracle overlay without its
    libraries and ``--mesh`` (a one-rank mesh over this lone process, taken
    down after) give the unsharded run's curves."""
    ap = trun_benchmark.build_parser()
    args = ap.parse_args(["--channel", "bsc", "--crossover-prob", "0.2", "--k-factor", "4"])
    assert (args.channel, args.crossover_prob, args.k_factor) == ("bsc", 0.2, 4.0)
    assert {a.dest for a in ap._actions} - {"device"} == \
        {a.dest for a in jrun_benchmark.build_parser()._actions} - {"platform"}
    root, want, _ = benchmark_runs
    assert not dist.is_initialized()
    try:
        got = trun_benchmark.main(benchmark_argv(tmp_path) + [
            "--use-third-party", "--mesh", "--device", "cpu", "--skip-complexity",
            "--output-dir", str(tmp_path / "out")])
    finally:
        dist.destroy_process_group()
    times = ("elapsed_seconds", "throughput_mbps")
    for family in ("polar", "ldpc"):
        assert set(got["ber_simulation"][family]) == {"self"}
        g, w = got["ber_simulation"][family]["self"], want["ber_simulation"][family]["self"]
        assert {k: v for k, v in g.items() if k not in times} == \
            {k: v for k, v in w.items() if k not in times}


# -- throughput probes ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_probe_keys():
    with jax.enable_x64(False):
        polar = jthpt.measure_polar_throughput(**POLAR, batch=8)
        ldpc = jthpt.measure_ldpc_throughput(**LDPC, batch=8, max_iter=5)
    return polar, ldpc


def test_throughput_probes(jax_probe_keys):
    jpolar, jldpc = jax_probe_keys
    for decoder in ("sc", "scl"):
        got = tthpt.measure_polar_throughput(**POLAR, batch=8, decoder=decoder, list_size=2,
                                             device="cpu")
        assert got.keys() == jpolar.keys()
        want_cfg = {**jpolar["config"], "decoder": decoder,
                    **({"list_size": 2} if decoder == "scl" else {})}
        assert got["config"] == want_cfg
        assert all(got[k] > 0 for k in got if k != "config")
    for impl in (None, "torch", "xla", "auto"):
        got = tthpt.measure_ldpc_throughput(**LDPC, batch=8, max_iter=5, bp_impl=impl,
                                            decoder="ms" if impl == "auto" else "bp",
                                            device="cpu")
        assert got.keys() == jldpc.keys()
        assert all(got[k] > 0 for k in got if k != "config")
    assert got["config"] == {**jldpc["config"], "decoder": "ms"}
    both = tthpt.run_throughput_test({**POLAR, "batch": 8}, {**LDPC, "batch": 8}, device="cpu")
    assert both.keys() == {"polar", "ldpc"}
    got = tthpt.measure_polar_throughput(**POLAR, batch=8, sc_impl="scan", device="cpu")
    assert got.keys() == jpolar.keys() and all(got[k] > 0 for k in got if k != "config")
    with pytest.raises(ValueError, match="cdua"):
        tthpt.measure_ldpc_throughput(**LDPC, batch=8, bp_impl="cdua", device="cpu")


def test_time_fn_counts_steady_state_calls():
    calls = []

    def fn(x):
        calls.append(time.perf_counter())
        return x + 1

    seconds = tthpt.time_fn(fn, torch.zeros(4), warmup=2, iters=3)
    assert len(calls) == 5 and 0 < seconds < 1


def test_cli_throughput(tmp_path, jax_probe_keys):
    jpolar, jldpc = jax_probe_keys
    got = tthroughput_cli.main(["--device", "cpu", "--polar-n", "64", "--polar-k", "32",
                                "--ldpc-n", "96", "--ldpc-k", "48", "--max-iter", "5",
                                "--batch", "8", "--output-dir", str(tmp_path)])
    assert got["polar"].keys() == jpolar.keys() and got["ldpc"].keys() == jldpc.keys()
    saved = json.loads((tmp_path / "data" / "throughput_results.json").read_text())
    assert saved.keys() == {"polar", "ldpc"} and saved["polar"]["config"]["N"] == 64
    got = tthroughput_cli.main(["--device", "cpu", "--polar-n", "64", "--polar-k", "32",
                                "--polar-decoder", "scl", "--list-size", "2", "--batch", "8",
                                "--skip-ldpc", "--output-dir", str(tmp_path)])
    assert got.keys() == {"polar"} and got["polar"]["config"]["list_size"] == 2
    assert {a.dest for a in tthroughput_cli.build_parser()._actions} - {"device"} == \
        {a.dest for a in __import__("polarcode_and_ldpc_tpu.cli.throughput", fromlist=["x"])
         .build_parser()._actions} - {"platform"}


# -- complexity, metrics, tracing ----------------------------------------------------------

def test_complexity_equals_jax():
    assert tcomplexity.analyze_complexity() == jcomplexity.analyze_complexity()
    p = {"N": 256, "K": 100, "list_size": 4}
    q = {"n": 1008, "k": 504, "dv": 3, "dc": 6, "max_iterations": 10}
    assert tcomplexity.analyze_complexity(p, q) == jcomplexity.analyze_complexity(p, q)
    assert tcomplexity.polar_complexity(64, 32) == jcomplexity.polar_complexity(64, 32)
    assert tcomplexity.ldpc_complexity(96, 48) == jcomplexity.ldpc_complexity(96, 48)


def test_decode_roofline_on_h100_peaks():
    """JAX's keys, with one H100's published peaks as the denominators."""
    got = tcomplexity.decode_roofline(1e6, 2e6, state_bytes_per_frame=4096)
    want = jcomplexity.decode_roofline(1e6, 2e6, state_bytes_per_frame=4096)
    assert got.keys() == want.keys()
    assert got["algorithmic_ops_per_s"] == want["algorithmic_ops_per_s"] == 2e12
    assert got["mfu_vs_bf16_peak"] == 2e12 / 989e12
    assert got["hbm_utilization_estimate"] == 4096 * 2e6 / 3.35e12
    assert tcomplexity.decode_roofline(1.0, 1.0).keys() == {"algorithmic_ops_per_s",
                                                           "mfu_vs_bf16_peak"}
    assert (tcomplexity.H100_PEAK_FLOPS_BF16, tcomplexity.H100_HBM_BYTES_PER_S) == (989e12,
                                                                                   3.35e12)


def test_metrics_helpers_equal_jax():
    for snr, rate in ((-1.0, 0.5), (3.0, 1 / 3), (2.5, 0.875)):
        assert tutils.snr_to_ebn0(snr, rate) == jmetrics.snr_to_ebn0(snr, rate)
        assert tutils.ebn0_to_snr(snr, rate, 2) == jmetrics.ebn0_to_snr(snr, rate, 2)
        assert math.isclose(tutils.ebn0_to_snr(tutils.snr_to_ebn0(snr, rate), rate), snr)
    g = np.random.default_rng(12)
    a = g.integers(0, 2, (32, 20)).astype(np.int8)
    b = a ^ (g.random((32, 20)) < 0.05).astype(np.int8)
    got = tutils.ber_fer_counts(torch.from_numpy(a), torch.from_numpy(b))
    want = jmetrics.ber_fer_counts(a, b)
    assert all(t.dtype == torch.int64 and t.dim() == 0 for t in got)
    assert [int(t) for t in got] == [int(w) for w in want]


def test_tracing(tmp_path, capsys):
    timer = tutils.Timer()
    x = torch.ones(8)
    for _ in range(3):
        with timer.span("decode", fence=(x * 2, {"aux": x})):
            x = x + 1
    with timer.span("other"):
        pass
    rep = timer.report()
    assert rep["decode"]["count"] == 3 and rep["other"]["count"] == 1
    assert timer.total("decode") >= timer.mean("decode") > 0 and timer.mean("none") == 0.0
    with tutils.timed_span("block"):
        pass
    assert capsys.readouterr().out.startswith("[block] ")
    counter = ttracing.decode_rate_counter(chips=2)
    counter.add(100, 512, 0.5)
    counter.add(100, 512, 0.5)
    assert counter.mbps == 102400 / 1e6 and counter.mbps_per_chip == counter.mbps / 2
    assert tutils.DecodeRateCounter().mbps == 0.0
    with tutils.profile_trace(tmp_path / "trace") as logdir:
        torch.ones(64).cumsum(0)
    (trace,) = list(logdir.glob("trace_*.json"))
    assert json.loads(trace.read_text())["traceEvents"]


# -- the configs the CLIs build ------------------------------------------------------------

def test_channel_config_reaches_every_entry_point():
    """``ChannelConfig`` of every kind runs through ``run_ber_simulation``."""
    sim = tcfg.SimulationConfig(snr_start=1, snr_stop=1, num_frames=64, batch_size=64)
    for kind in ("awgn", "bsc", "rayleigh", "rician"):
        res = texp.run_ber_simulation(tcfg.PolarCodeConfig(**POLAR),
                                      tcfg.LDPCCodeConfig(**LDPC, max_iterations=5), sim,
                                      channel=tcfg.ChannelConfig(kind=kind), device="cpu")
        assert res["polar"]["self"]["frames_tested"] == [64]
        assert res["ldpc"]["self"]["frames_tested"] == [64]
    assert dataclasses.asdict(tcfg.ChannelConfig()) == dataclasses.asdict(jcfg.ChannelConfig())
