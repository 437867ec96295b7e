"""The sweep CLIs of the port against the JAX package, on the CPU:
``code_params`` with ``test_code_lengths``, and ``sc_vs_scl`` in both modes
(``--device cpu``).  Codes are tiny (polar N ≤ 64, LDPC n ≤ 96).

JAX runs with ``jax_enable_x64`` off, as a user runs it.  Curves are compared
with ``same_curve`` (``test_torch_snr_curves.py``), a code-parameter entry by
its keys, its error and its FER within one frame; times and rates are each
run's own, and only their keys and that the rates are positive are checked.
"""

import json

import jax
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
from polarcode_and_ldpc_tpu.cli import code_params as jcode_params
from polarcode_and_ldpc_tpu.cli import sc_vs_scl as jsc_vs_scl
from polarcode_and_ldpc_tpu.core import config as jcfg
from polarcode_and_ldpc_tpu.models.polar.construction import construct_polar_code as jconstruct
from polarcode_and_ldpc_tpu_torch.cli import code_params as tcode_params
from polarcode_and_ldpc_tpu_torch.cli import sc_vs_scl as tsc_vs_scl
from polarcode_and_ldpc_tpu_torch.sim import experiments as texp
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


def same_entry(got: dict, want: dict, frames: int):
    """One code-parameter entry: the same keys (an error where JAX records
    one; the port's config raises ``ValueError`` with its own message where
    JAX's asserts), and BER / FER within one frame of JAX's."""
    assert got.keys() == want.keys(), (got, want)
    if "error" in want:
        return
    assert abs(got["fer"] - want["fer"]) <= 1.0 / frames + 1e-12
    for key in got:
        if key.endswith("throughput") or key in ("throughput_mbps", "decode_ms_per_frame"):
            assert got[key] > 0


# -- code-parameter sweeps ---------------------------------------------------------------

def _build_error(build):
    try:
        build()
    except (ValueError, AssertionError) as e:
        return str(e)
    return None


def test_code_params_default_entries_error_as_jax():
    """Built alone, the codes of the default length and rate sweeps raise in
    the same entries (there the CLIs record ``"error"``; no other failure is
    recorded)."""
    ap = tcode_params.build_parser().parse_args([])
    entries = [(f, int(n), 0.5, 3, 6) for f, lens in (("polar", ap.polar_lengths),
                                                      ("ldpc", ap.ldpc_lengths))
               for n in lens.split(",")]
    N = ap.rate_length
    for rate in map(float, ap.rates.split(",")):
        K = int(N * rate)
        entries += [("polar", N, rate, 3, 6),
                    ("ldpc", N, rate, 3, max(4, int(round(3 * N / (N - K)))))]
    for family, n, rate, dv, dc in entries:
        k = int(n * rate)
        got = _build_error(lambda: texp.build_code(family, n, k, dv, dc, device="cpu"))
        if family == "polar":
            want = _build_error(lambda: (jcfg.PolarCodeConfig(N=n, K=k, algorithm="sc"),
                                         jconstruct(n, k, "bhattacharyya", 2.0)))
        else:
            want = _build_error(lambda: jfec.LDPCEncoder(
                jcfg.LDPCCodeConfig(n=n, k=k, dv=dv, dc=dc).n, k, dv=dv, dc=dc, seed=42))
        assert (got is None) == (want is None), (family, n, rate, got, want)
    with pytest.raises(ValueError, match="power of 2"):
        texp.build_code("polar", 48, 24, device="cpu")


CODE_PARAMS = dict(snr_db=1.0, num_frames=128, batch_size=64)


@pytest.fixture(scope="module")
def code_params_runs(tmp_path_factory):
    """``code_params`` of each package, once: lengths polar 32 / 48 and LDPC
    48, rate 0.33 at length 64 (its LDPC degrees do not fit a regular code)."""
    root = tmp_path_factory.mktemp("code_params")
    argv = ["--polar-lengths", "32,48", "--ldpc-lengths", "48", "--rates", "0.33",
            "--rate-length", "64", "--snr-db", "1.0", "--num-frames", "128",
            "--batch-size", "64"]
    with jax.enable_x64(False):
        want = jcode_params.main(argv + ["--output-dir", str(root / "jax")])
    got = tcode_params.main(argv + ["--output-dir", str(root / "port"), "--device", "cpu"])
    return root, got, want


def test_cli_code_params_equals_jax(code_params_runs):
    root, got, want = code_params_runs
    assert got.keys() == want.keys() == {"length_tests", "rate_tests"}
    for sweep in got:
        assert got[sweep].keys() == want[sweep].keys() == {"polar", "ldpc"}
        for family in got[sweep]:
            assert len(got[sweep][family]) == len(want[sweep][family])
            for g, w in zip(got[sweep][family], want[sweep][family]):
                same_entry(g, w, 128)
    assert "error" in got["length_tests"]["polar"][1]  # N=48 is not a power of 2
    assert json.loads((root / "port" / "code_params_results.json").read_text()).keys() == \
        json.loads((root / "jax" / "code_params_results.json").read_text()).keys()


def test_code_lengths_equal_jax(code_params_runs):
    """``test_code_lengths`` called directly, against the JAX CLI's length
    sweep (which runs JAX's ``test_code_lengths`` with these arguments), with
    the SC kernel's plain version named."""
    _, _, want = code_params_runs
    for family, lengths in (("polar", [32, 48]), ("ldpc", [48])):
        got = texp.test_code_lengths(family, lengths, rate=0.5, sc_impl="unrolled",
                                     device="cpu", **CODE_PARAMS)
        assert [e["length"] for e in got] == lengths
        for g, w in zip(got, want["length_tests"][family]):
            same_entry(g, w, CODE_PARAMS["num_frames"])


# -- SC against SCL -------------------------------------------------------------------

def test_cli_sc_vs_scl_quick_equals_jax(tmp_path):
    argv = ["--N", "32", "--K", "16", "--list-sizes", "1,2", "--snr-db", "0.5",
            "--num-frames", "256", "--max-errors", "1000", "--batch-size", "64"]
    with jax.enable_x64(False):
        want = jsc_vs_scl.main(argv + ["--output-dir", str(tmp_path / "jax")])
    got = tsc_vs_scl.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert got.keys() == want.keys() == {"mode", "N", "K", "snr_db", "sc", "scl_1", "scl_2"}
    differ = 0
    for name in ("sc", "scl_1", "scl_2"):
        assert got[name].keys() == want[name].keys()
        assert got[name]["frames"] == want[name]["frames"] == 256
        differ += abs(got[name]["frame_errors"] - want[name]["frame_errors"])
    assert differ <= 1 and want["sc"]["frame_errors"] > 0
    assert (tmp_path / "port" / "quick_results.json").exists()


def test_cli_sc_vs_scl_full_equals_jax(tmp_path):
    """Two points, CA-SCL-2 (CRC-8), with the latency probes; the summary
    plot is drawn where matplotlib is installed."""
    argv = ["--mode", "full", "--N", "32", "--K", "16", "--list-sizes", "2",
            "--snr-range", "0:1:1", "--num-frames", "256", "--max-errors", "1000",
            "--batch-size", "64", "--use-crc", "--skip-plots"]
    with jax.enable_x64(False):
        want = jsc_vs_scl.main(argv + ["--output-dir", str(tmp_path / "jax")])
    got = tsc_vs_scl.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert got.keys() == want.keys()
    assert got["curves"].keys() == want["curves"].keys() == {"sc", "scl_2"}
    for name in got["curves"]:
        same_curve(got["curves"][name], want["curves"][name])
    assert got["latency_ms_per_frame"].keys() == want["latency_ms_per_frame"].keys()
    assert all(v > 0 for v in got["latency_ms_per_frame"].values())
    pytest.importorskip("matplotlib")
    tsc_vs_scl.plot_improvement_summary(got, tmp_path / "improvement.png")
    assert (tmp_path / "improvement.png").stat().st_size > 0
