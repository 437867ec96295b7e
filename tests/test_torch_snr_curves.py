"""The SNR-curve entry point of the port against the JAX package, on the CPU:
the config dataclasses and ``convert.config_from_jax``, ``run_snr_sweep``,
``test_multiple_rates`` and the CLI ``cli.snr_curves.main`` on tiny codes
(polar N=64 CA-SCL-4 with fast nodes, LDPC n=96).

JAX runs these entry points with ``jax_enable_x64`` off here (``with
jax.enable_x64(False)``), as a user runs them, so both packages draw the same
32-bit message bits.  Integer randomness is equal bit for bit; the float32
noise agrees to 1e-6 (``erf_inv``, see ``test_torch_rng.py``), so a frame
whose LLRs sit on a decision boundary may decode otherwise: at most 1 frame in
256 may differ.  Times and rates are each run's own and are not compared.
"""

import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu.cli import snr_curves as jcli
from polarcode_and_ldpc_tpu.core import config as jcfg
from polarcode_and_ldpc_tpu.sim import experiments as jexp
from polarcode_and_ldpc_tpu.sim import pipelines as jpipes
from polarcode_and_ldpc_tpu.sim import sweep as jsweep
from polarcode_and_ldpc_tpu_torch.cli import snr_curves as tcli
from polarcode_and_ldpc_tpu_torch.convert import config_from_jax
from polarcode_and_ldpc_tpu_torch.core import config as tcfg
from polarcode_and_ldpc_tpu_torch.sim import experiments as texp
from polarcode_and_ldpc_tpu_torch.sim import pipelines as tpipes
from polarcode_and_ldpc_tpu_torch.sim import sweep as tsweep
from polarcode_and_ldpc_tpu_torch.utils import visualization as tvis

CLI_ARGS = ["--polar-n", "64", "--ldpc-n", "96", "--rates", "0.5", "--snr-range=-1:1:1",
            "--num-frames", "256", "--max-errors", "1000", "--batch-size", "64",
            "--polar-algorithm", "ca_scl", "--list-size", "4", "--scl-chunk", "16",
            "--scl-node-mode", "fast", "--skip-plots", "--seed", "7"]


def same_curve(got: dict, want: dict):
    """Equal keys and configs; per point the same frame count, frame errors
    within one frame, and bit errors equal unless a frame differs."""
    assert set(got) == set(want)
    assert got.get("config") == want.get("config")
    assert got["snr_db"] == list(want["snr_db"])
    differ = 0
    for i in range(len(want["snr_db"])):
        assert got["frames_tested"][i] == want["frames_tested"][i]
        d = abs(got["frame_errors"][i] - want["frame_errors"][i])
        differ += d
        if d == 0:
            assert got["bit_errors"][i] == want["bit_errors"][i], i
        np.testing.assert_allclose(got["avg_iterations"][i], want["avg_iterations"][i],
                                   rtol=0, atol=20 / got["frames_tested"][i])
    assert differ <= max(1, sum(want["frames_tested"]) // 256), (got, want)
    assert sum(want["frame_errors"]) > 0  # the curves saw errors to count


# -- configs -----------------------------------------------------------------------

def test_config_defaults_equal_jax_but_the_implementation_choices():
    for name in ("PolarCodeConfig", "LDPCCodeConfig", "ChannelConfig", "SimulationConfig"):
        j = dataclasses.asdict(getattr(jcfg, name)())
        t = dataclasses.asdict(getattr(tcfg, name)())
        assert set(j) == set(t), name
        own = {"scl_body_impl", "scl_control_impl", "bp_impl"}
        assert {k: v for k, v in j.items() if k not in own} == \
            {k: v for k, v in t.items() if k not in own}, name
        assert all(t[k] is None for k in own & set(t)), name
    assert tcfg.PolarCodeConfig(N=64, K=16).rate == jcfg.PolarCodeConfig(N=64, K=16).rate
    for bad in (dict(N=100, K=10), dict(N=64, K=64)):
        with pytest.raises(ValueError):
            tcfg.PolarCodeConfig(**bad)
    with pytest.raises(ValueError):
        tcfg.LDPCCodeConfig(n=10, k=10)


@pytest.mark.parametrize("spec", ["-2:6:0.5", "-1:1:1", "0.25:0.25:1", "3:-1:1"])
def test_snr_points_equal_jax(spec):
    t = tcfg.SimulationConfig.from_range_string(spec, num_frames=7)
    j = jcfg.SimulationConfig.from_range_string(spec, num_frames=7)
    assert t.snr_points() == j.snr_points() and t.num_frames == 7


def test_config_from_jax():
    j = jcfg.PolarCodeConfig(N=256, K=100, algorithm="ca_scl", list_size=4,
                             scl_node_mode="fast", scl_control_impl="split")
    t = config_from_jax(j)
    assert isinstance(t, tcfg.PolarCodeConfig)
    # JAX's list controls stay as they are; its chunk bodies become the device's choice
    assert dataclasses.asdict(t) == {**dataclasses.asdict(j), "scl_body_impl": None}
    j = jcfg.PolarCodeConfig(scl_control_impl="unroll-kernel", scl_body_impl="pallas")
    assert (config_from_jax(j).scl_control_impl, config_from_jax(j).scl_body_impl) == (
        "unroll-kernel", None)
    j = jcfg.PolarCodeConfig(scl_control_impl="kernel-interpret")
    assert config_from_jax(j).scl_control_impl is None
    j = jcfg.LDPCCodeConfig(n=96, k=48, bp_impl="pallas", algorithm="nms")
    assert dataclasses.asdict(config_from_jax(j)) == {**dataclasses.asdict(j), "bp_impl": None}
    for j in (jcfg.ChannelConfig(snr_db=-1.0), jcfg.SimulationConfig(num_frames=9, seed=3)):
        assert dataclasses.asdict(config_from_jax(j)) == dataclasses.asdict(j)
    with pytest.raises(TypeError):
        config_from_jax(jcfg.SimulationConfig)
    with pytest.raises(TypeError):
        config_from_jax(object())


def test_load_yaml_config_equal_jax(tmp_path, monkeypatch):
    pytest.importorskip("yaml")
    path = tmp_path / "polar.yaml"
    path.write_text("code_params:\n  N: 128\n  K: 64\ndecoding:\n  algorithm: scl\n  L: 4\n"
                    "construction:\n  method: dega\n  design_snr_db: 1.5\nunused: 3\n")
    t = tcfg.load_yaml_config(path, tcfg.PolarCodeConfig)
    j = jcfg.load_yaml_config(path, jcfg.PolarCodeConfig)
    assert dataclasses.asdict(t) == {**dataclasses.asdict(j), "scl_body_impl": None,
                                     "scl_control_impl": None}
    assert tcfg.load_yaml_config(path) == jcfg.load_yaml_config(path)
    monkeypatch.setitem(sys.modules, "yaml", None)  # a machine without PyYAML
    with pytest.raises(ImportError, match="PyYAML"):
        tcfg.load_yaml_config(path)


# -- the sweep, the experiments, the CLI ---------------------------------------------

def test_run_snr_sweep_equals_jax():
    """An SC polar sweep through one runtime-SNR step, and an LDPC sweep
    through a builder that takes a concrete SNR (one step per point)."""
    N, K = 64, 32
    frozen, _ = tfec.construct_polar_code(N, K, "bhattacharyya", 2.0)
    kw = dict(snr_points=[-1.0, 0.5], num_frames=256, max_errors=30, seed=5, chunk_frames=64)
    with jax.enable_x64(False):
        want = jsweep.run_snr_sweep(lambda s: jpipes.make_polar_pipeline(N, K, frozen, s), K,
                                    **kw)
    got = tsweep.run_snr_sweep(
        lambda s: tpipes.make_polar_pipeline(N, K, frozen, s, device="cpu"), K, **kw)
    same_curve(got, want)
    assert got["frames_tested"][0] < 256  # the early stop crossed at 30 errors

    enc = tfec.LDPCEncoder(96, 48, dv=3, dc=6, seed=42, device="cpu")

    def concrete(build):
        def builder(snr):
            if snr is None:
                raise TypeError("this builder needs a concrete SNR")
            return build(snr)
        return builder

    with jax.enable_x64(False):
        want = jsweep.run_snr_sweep(concrete(lambda s: jpipes.make_ldpc_pipeline(
            enc.H, enc.G, s, max_iter=10, message_idx=enc.info_positions)), 48, **kw)
    got = tsweep.run_snr_sweep(concrete(lambda s: tpipes.make_ldpc_pipeline(
        enc.H, enc.G, s, max_iter=10, message_idx=enc.info_positions, device="cpu")), 48, **kw)
    same_curve(got, want)
    with pytest.raises(NotImplementedError, match="mesh"):
        tsweep.run_snr_sweep(lambda s: None, 1, [0.0], mesh=object())


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The SNR-curve CLI of each package, once: fast CA-SCL-4 polar and BP
    LDPC at rate 0.5, three SNR points, 256 frames each."""
    root = tmp_path_factory.mktemp("snr_curves")
    with jax.enable_x64(False):
        want = jcli.main(CLI_ARGS + ["--output-dir", str(root / "jax")])
    got = tcli.main(CLI_ARGS + ["--output-dir", str(root / "port"), "--device", "cpu"])
    return root, got, want


def test_cli_snr_curves_equals_jax(cli_runs):
    root, got, want = cli_runs
    assert set(got) == set(want) == {"polar", "ldpc", "analysis"}
    for family in ("polar", "ldpc"):
        assert set(got[family]["self"]) == set(want[family]["self"]) == {"0.50"}
        same_curve(got[family]["self"]["0.50"], want[family]["self"]["0.50"])
    assert got["polar"]["self"]["0.50"]["config"]["decoder"] == "ca-scl"
    for name in ("polar_results.json", "ldpc_results.json", "snr_analysis.json"):
        t = json.loads((root / "port" / name).read_text())
        j = json.loads((root / "jax" / name).read_text())
        if name == "snr_analysis.json":
            assert t.keys() == j.keys() and all(t[k].keys() == j[k].keys() for k in t)
        else:
            assert t.keys() == j.keys() and t["self"].keys() == j["self"].keys()
    assert not list((root / "port").glob("*.png"))  # --skip-plots


def test_multiple_rates_and_ber_simulation_equal_jax(cli_runs):
    """``test_multiple_rates`` of the port equals the CLI's JAX curves (the
    CLI runs it), and ``run_ber_simulation`` gives JAX's schema."""
    _, _, want = cli_runs
    sim = tcfg.SimulationConfig(snr_start=-1, snr_stop=1, snr_step=1, num_frames=256,
                                max_errors=1000, batch_size=64, seed=7)
    got = texp.test_multiple_rates("ldpc", (0.5,), N=96, sim=sim, device="cpu")
    same_curve(got["self"]["0.50"], want["ldpc"]["self"]["0.50"])
    assert texp.analyze_snr_requirements(got["self"]) == \
        jexp.analyze_snr_requirements(want["ldpc"]["self"])
    polar = tcfg.PolarCodeConfig(N=64, K=32, algorithm="scl", list_size=2, scl_chunk=16)
    small = dataclasses.replace(sim, num_frames=64, snr_stop=-1)
    res = texp.run_ber_simulation(polar, tcfg.LDPCCodeConfig(n=96, k=48), small, device="cpu")
    with jax.enable_x64(False):
        jres = jexp.run_ber_simulation(jcfg.PolarCodeConfig(N=64, K=32, algorithm="scl",
                                                            list_size=2, scl_chunk=16),
                                       jcfg.LDPCCodeConfig(n=96, k=48),
                                       jcfg.SimulationConfig(**dataclasses.asdict(small)))
    assert res.keys() == jres.keys() and res["snr_range"] == jres["snr_range"]
    for family in ("polar", "ldpc"):
        same_curve(res[family]["self"], jres[family]["self"])


def test_unported_parts_raise(tmp_path):
    sim = tcfg.SimulationConfig(snr_start=0, snr_stop=0, num_frames=8, batch_size=8)
    polar = tcfg.PolarCodeConfig(N=32, K=16)
    with pytest.raises(NotImplementedError, match="rayleigh"):
        texp.simulate_polar(polar, sim, channel=tcfg.ChannelConfig(kind="rayleigh"),
                            device="cpu")
    with pytest.raises(NotImplementedError, match="oracle"):
        texp.run_ber_simulation(polar, sim=sim, use_oracle=True, device="cpu")
    with pytest.raises(NotImplementedError, match="throughput"):
        texp.test_code_lengths("polar", [64])
    with pytest.raises(NotImplementedError, match="mesh"):
        texp.simulate_polar(polar, sim, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="family"):
        texp.test_multiple_rates("turbo", (0.5,), sim=sim, device="cpu")
    for flag in (["--mesh"], ["--distributed"], ["--host-devices", "4"]):
        with pytest.raises(NotImplementedError, match=flag[0]):
            tcli.main(flag + ["--device", "cpu", "--output-dir", str(tmp_path)])
    # JAX's list controls are the port's too; an interpret twin of a Pallas control is not
    assert tcli.build_parser().parse_args(["--scl-control", "split"]).scl_control == "split"
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["--scl-control", "kernel-interpret"])


def test_save_results_and_plots(tmp_path, monkeypatch):
    res = {"a": torch.tensor([1.5, 2.0]), "b": np.int64(3), "c": [np.float32(0.5), np.bool_(True)],
           "d": {1: np.arange(3)}, "e": None}
    tvis.save_results(res, tmp_path / "x" / "r.json")
    assert json.loads((tmp_path / "x" / "r.json").read_text()) == {
        "a": [1.5, 2.0], "b": 3, "c": [0.5, True], "d": {"1": [0, 1, 2]}, "e": None}
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # a machine without matplotlib
    with pytest.raises(ImportError, match="matplotlib"):
        tvis.plot_ber_curves([0.0, 1.0], {"x": [0.1, 0.01]}, filepath=tmp_path / "p.png")
    with pytest.raises(ImportError, match="matplotlib"):
        tvis.plot_comparison(["a"], {"x": [1.0]}, filepath=tmp_path / "c.png")
