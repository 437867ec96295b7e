"""The third-party oracles of the port against the JAX package's: the
committed fixture, the import-gated wrappers (neither ``polarcodes`` nor
``pyldpc`` is installed), the constructions behind ``oracle_*``, the library
curves with stub libraries injected, and the oracle-differential CLI.

JAX's entry points run with ``jax_enable_x64`` off (``with
jax.enable_x64(False)``), as a user runs them, so both packages draw the same
message bits; the float32 noise may put one frame in 256 on the other side of
a decision (``test_torch_snr_curves.same_curve``).
"""

import importlib
import json
import sys
import types

import jax
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu.oracle as joracle
import polarcode_and_ldpc_tpu_torch.oracle as toracle
from polarcode_and_ldpc_tpu.cli import oracle_differential as jcli
from polarcode_and_ldpc_tpu.core import config as jcfg
from polarcode_and_ldpc_tpu.oracle import fixtures as jfixtures
from polarcode_and_ldpc_tpu.oracle import ldpc_oracle as jldpc_oracle
from polarcode_and_ldpc_tpu.oracle import polar_oracle as jpolar_oracle
from polarcode_and_ldpc_tpu.sim import experiments as jexp
from polarcode_and_ldpc_tpu_torch.cli import oracle_differential as tcli
from polarcode_and_ldpc_tpu_torch.core import config as tcfg
from polarcode_and_ldpc_tpu_torch.oracle import fixtures as tfixtures
from polarcode_and_ldpc_tpu_torch.oracle import ldpc_oracle as tldpc_oracle
from polarcode_and_ldpc_tpu_torch.oracle import polar_oracle as tpolar_oracle
from polarcode_and_ldpc_tpu_torch.sim import experiments as texp
from test_torch_snr_curves import same_curve

SMOKE_ARGS = ["--num-frames", "128", "--max-errors", "50", "--batch-size", "64",
              "--snr-range", "2:3:1", "--polar-n", "64", "--polar-k", "32",
              "--ldpc-n", "24", "--ldpc-k", "12", "--dv", "2", "--dc", "4", "--skip-plots"]


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


# -- fixture, availability, constructions -----------------------------------------------

def test_fixture_loads_equal_jax():
    """The port reads the committed file where it lies, as JAX does."""
    assert tfixtures.DEFAULT_FIXTURE == jfixtures.DEFAULT_FIXTURE
    assert tfixtures.DEFAULT_FIXTURE.exists()
    got, want = tfixtures.load_oracle_fixture(), jfixtures.load_oracle_fixture()
    for fam in ("polar", "ldpc"):
        assert got[fam].keys() == want[fam].keys()
        for k, v in want[fam].items():
            if isinstance(v, np.ndarray):
                assert got[fam][k].dtype == v.dtype and np.array_equal(got[fam][k], v), k
            else:
                assert got[fam][k] == v, k
    ldpc = got["ldpc"]
    assert ldpc["G_nk"].shape == (ldpc["n"], ldpc["k_actual"])
    assert ((ldpc["H"] @ ldpc["G_nk"]) % 2 == 0).all()


def test_libraries_absent_and_wrappers_raise():
    for which in ("polar", "ldpc", "turbo"):
        assert toracle.oracle_available(which) is joracle.oracle_available(which) is False
    assert tpolar_oracle.POLARCODES_AVAILABLE is jpolar_oracle.POLARCODES_AVAILABLE is False
    assert tldpc_oracle.PYLDPC_AVAILABLE is jldpc_oracle.PYLDPC_AVAILABLE is False
    with pytest.raises(ImportError, match="polarcodes"):
        tpolar_oracle.PolarLibWrapper(64, 32)
    with pytest.raises(ImportError, match="pyldpc"):
        tldpc_oracle.LDPCLibWrapper(24)


@pytest.mark.parametrize("N,K,design", [(64, 32, 2.0), (256, 100, 0.0), (1024, 512, 2.0)])
def test_oracle_frozen_set_equals_jax(N, K, design):
    got, backend = toracle.oracle_polar_frozen_set(N, K, design)
    want, jbackend = joracle.oracle_polar_frozen_set(N, K, design)
    assert backend == jbackend == "numpy-reimpl"
    assert np.array_equal(got, want) and got.shape == (N - K,)


@pytest.mark.parametrize("n,dv,dc,seed", [(24, 2, 4, 42), (504, 3, 6, 42), (96, 3, 6, 7)])
def test_oracle_ldpc_matrices_equal_jax(n, dv, dc, seed):
    H, G, backend = toracle.oracle_ldpc_matrices(n, dv, dc, seed)
    jH, jG, jbackend = joracle.oracle_ldpc_matrices(n, dv, dc, seed)
    assert backend == jbackend == "numpy-reimpl"
    assert np.array_equal(H, jH) and np.array_equal(G, jG)
    assert ((H @ G) % 2 == 0).all()


def test_ber_simulation_without_libraries_equals_use_oracle_false():
    sim = tcfg.SimulationConfig(snr_start=1, snr_stop=2, snr_step=1, num_frames=64,
                                max_errors=20, batch_size=64, seed=3)
    polar, ldpc = tcfg.PolarCodeConfig(N=32, K=16), tcfg.LDPCCodeConfig(n=24, k=12, dv=2, dc=4)
    strip = lambda r: {f: {a: {k: v for k, v in c.items()  # noqa: E731
                               if k not in ("elapsed_seconds", "throughput_mbps")}
                           for a, c in r[f].items()} for f in ("polar", "ldpc")}
    on = texp.run_ber_simulation(polar, ldpc, sim, use_oracle=True, device="cpu")
    off = texp.run_ber_simulation(polar, ldpc, sim, use_oracle=False, device="cpu")
    assert strip(on) == strip(off) and set(on["polar"]) == {"self"}


# -- stub libraries ----------------------------------------------------------------------

def _stub_polarcodes():
    """A ``polarcodes`` stand-in with the calls the wrapper makes: the NumPy
    construction, the butterfly encode, a hard-decision decode."""
    from polarcode_and_ldpc_tpu_torch.parity.polar_np import polar_transform_np

    mod = types.ModuleType("polarcodes")

    class PolarCode:
        def __init__(self, n, K):
            self.N, self.K = 1 << n, K

        def set_message(self, m):
            self.message = m

        def get_codeword(self):
            return self.x

    def Construct(pc, snr):
        pc.frozen = toracle.constructions_np.polar_construct_np(pc.N, pc.K, snr)[0][::-1]
        pc.info = np.setdiff1d(np.arange(pc.N), pc.frozen)

    def Encode(pc):
        u = np.zeros(pc.N, np.int64)
        u[pc.info] = pc.message
        pc.x = polar_transform_np(u)

    def Decode(pc, name):
        assert name == "scd"
        pc.message_received = polar_transform_np((pc.likelihoods < 0).astype(np.int64))[pc.info]

    mod.PolarCode, mod.Construct, mod.Encode, mod.Decode = PolarCode, Construct, Encode, Decode
    return mod


def _stub_pyldpc():
    """A ``pyldpc`` stand-in: the NumPy ``make_ldpc``, BPSK of the GF(2)
    product, a hard decision, the systematic message positions."""
    mod = types.ModuleType("pyldpc")
    mod.make_ldpc = lambda n, dv, dc, systematic, seed: \
        toracle.constructions_np.make_ldpc_np(n, dv, dc, seed=seed)
    mod.encode = lambda G, m, snr: 1.0 - 2.0 * ((G @ m) % 2)
    mod.decode = lambda H, y, snr, maxiter: (y < 0).astype(np.int64)
    mod.get_message = lambda G, d: d[:G.shape[1]]
    return mod


@pytest.fixture
def stub_libraries():
    """Both stubs in ``sys.modules`` and both packages' oracle modules
    reloaded to see them; everything restored at teardown."""
    modules = (jpolar_oracle, tpolar_oracle, jldpc_oracle, tldpc_oracle)
    saved = {name: sys.modules.get(name) for name in ("polarcodes", "pyldpc")}
    sys.modules.update(polarcodes=_stub_polarcodes(), pyldpc=_stub_pyldpc())
    try:
        for m in modules:
            importlib.reload(m)
        yield
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
        for m in modules:
            importlib.reload(m)
        assert not tpolar_oracle.POLARCODES_AVAILABLE and not tldpc_oracle.PYLDPC_AVAILABLE


def test_stub_libraries_simulate_and_overlay_equal_jax(stub_libraries):
    """``simulate_*_oracle`` and the ``"library"`` curves of
    ``run_ber_simulation(use_oracle=True)``: the port equals JAX's, and the
    self curves equal JAX's to the float32 noise."""
    assert toracle.oracle_available("polar") and toracle.oracle_available("ldpc")
    assert tpolar_oracle.POLARCODES_AVAILABLE and tldpc_oracle.PYLDPC_AVAILABLE
    frozen, backend = toracle.oracle_polar_frozen_set(32, 16, 1.0)
    assert backend == "polarcodes" and np.array_equal(
        frozen, joracle.oracle_polar_frozen_set(32, 16, 1.0)[0])
    assert toracle.oracle_ldpc_matrices(24, 2, 4)[2] == "pyldpc"
    kw = dict(snr_start=0, snr_stop=2, snr_step=2, num_frames=64, max_errors=10,
              batch_size=64, seed=3)
    polar = dict(N=32, K=16, design_snr_db=1.0)
    ldpc = dict(n=24, k=12, dv=2, dc=4, max_iterations=10)
    sim, jsim = tcfg.SimulationConfig(**kw), jcfg.SimulationConfig(**kw)
    got_p = tpolar_oracle.simulate_polar_oracle(tcfg.PolarCodeConfig(**polar), sim)
    got_l = tldpc_oracle.simulate_ldpc_oracle(tcfg.LDPCCodeConfig(**ldpc), sim)
    assert got_p == jpolar_oracle.simulate_polar_oracle(jcfg.PolarCodeConfig(**polar), jsim)
    assert got_l == jldpc_oracle.simulate_ldpc_oracle(jcfg.LDPCCodeConfig(**ldpc), jsim)
    assert sum(got_p["frames_tested"]) > 0
    assert got_l["k"] == toracle.oracle_ldpc_matrices(24, 2, 4)[1].shape[1]  # pyldpc's k_actual
    res = texp.run_ber_simulation(tcfg.PolarCodeConfig(**polar), tcfg.LDPCCodeConfig(**ldpc),
                                  sim, use_oracle=True, device="cpu")
    with jax.enable_x64(False):
        want = jexp.run_ber_simulation(jcfg.PolarCodeConfig(**polar),
                                       jcfg.LDPCCodeConfig(**ldpc), jsim, use_oracle=True)
    for fam, lib in (("polar", got_p), ("ldpc", got_l)):
        assert set(res[fam]) == set(want[fam]) == {"self", "library"}
        assert res[fam]["library"] == want[fam]["library"] == lib
        same_curve(res[fam]["self"], want[fam]["self"])


# -- the oracle-differential CLI ----------------------------------------------------------

def test_oracle_differential_cli_equals_jax(tmp_path):
    """JAX's smoke arguments through both CLIs: the same JSON keys, frame
    counts and errors (to the float32 noise), overlap, ``k_actual``, backends
    and gaps."""
    with jax.enable_x64(False):
        assert jcli.main(["--platform", "cpu", "--output-dir", str(tmp_path / "jax")]
                         + SMOKE_ARGS) == 0
    assert tcli.main(["--device", "cpu", "--output-dir", str(tmp_path / "port")]
                     + SMOKE_ARGS) == 0
    got = json.loads((tmp_path / "port" / "oracle_differential.json").read_text())
    want = json.loads((tmp_path / "jax" / "oracle_differential.json").read_text())
    assert got.keys() == want.keys() and got["snr_db"] == want["snr_db"]
    for fam in ("polar", "ldpc"):
        assert got[fam].keys() == want[fam].keys()
        for arm in ("self", "oracle"):
            if sum(want[fam][arm]["frame_errors"]):
                same_curve(got[fam][arm], want[fam][arm])
            else:  # no error at these SNRs (the polar arm): nothing may differ
                for k in ("frames_tested", "bit_errors", "frame_errors"):
                    assert got[fam][arm][k] == want[fam][arm][k], (fam, arm, k)
        assert got[fam]["oracle_backend"] == want[fam]["oracle_backend"] == "numpy-reimpl"
        if all(got[fam][a]["bit_errors"] == want[fam][a]["bit_errors"] for a in ("self", "oracle")):
            assert got[fam]["gap"] == want[fam]["gap"]  # the gaps follow from the counts
        assert got[fam]["self"]["frames_tested"][0] > 0
    assert got["polar"]["frozen_overlap"] == want["polar"]["frozen_overlap"] > 0
    assert got["ldpc"]["k_actual"] == want["ldpc"]["k_actual"]
    assert tcli.build_parser().parse_args([]).output_dir == "results/oracle_differential"
    assert {a.dest for a in tcli.build_parser()._actions} - {"device"} == \
        {a.dest for a in jcli.build_parser()._actions} - {"platform"}
    assert not list((tmp_path / "port").glob("*.png"))  # --skip-plots
