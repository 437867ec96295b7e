"""The port stands alone: no module of it (nor ``chip_smoke.py``) imports
``jax`` or the JAX package, and importing it builds no kernel."""

import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "polarcode_and_ldpc_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "polarcode_and_ldpc_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_sources_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for expected in ("polarcode_and_ldpc_tpu_torch/core/rng.py",
                     "polarcode_and_ldpc_tpu_torch/ops/sc_mega_cuda.py",
                     "polarcode_and_ldpc_tpu_torch/ops/bp_cuda.py",
                     "polarcode_and_ldpc_tpu_torch/ops/scl_cuda.py",
                     "polarcode_and_ldpc_tpu_torch/models/polar/scanscl.py",
                     "polarcode_and_ldpc_tpu_torch/models/polar/scl.py",
                     "polarcode_and_ldpc_tpu_torch/models/polar/crc.py",
                     "polarcode_and_ldpc_tpu_torch/models/polar/adaptive.py",
                     "polarcode_and_ldpc_tpu_torch/models/ldpc/layered.py",
                     "polarcode_and_ldpc_tpu_torch/models/ldpc/qc.py",
                     "polarcode_and_ldpc_tpu_torch/sim/montecarlo.py",
                     "polarcode_and_ldpc_tpu_torch/ops/fastnode_cuda.py",
                     "polarcode_and_ldpc_tpu_torch/core/config.py",
                     "polarcode_and_ldpc_tpu_torch/sim/sweep.py",
                     "polarcode_and_ldpc_tpu_torch/sim/experiments.py",
                     "polarcode_and_ldpc_tpu_torch/utils/visualization.py",
                     "polarcode_and_ldpc_tpu_torch/cli/_common.py",
                     "polarcode_and_ldpc_tpu_torch/cli/snr_curves.py",
                     "polarcode_and_ldpc_tpu_torch/convert.py", "chip_smoke.py"):
        assert expected in names
    assert (PKG / "ops" / "csrc" / "sc_decode.cu").exists()
    assert (PKG / "ops" / "csrc" / "bp_decode.cu").exists()
    assert (PKG / "ops" / "csrc" / "scl_decode.cu").exists()
    assert (PKG / "ops" / "csrc" / "scl_device.cuh").exists()
    assert (PKG / "ops" / "csrc" / "fastnode.cu").exists()
    assert (PKG / "ops" / "csrc" / "fastnode_device.cuh").exists()


def test_no_source_imports_jax_or_the_jax_package():
    bad = [(p.relative_to(ROOT).as_posix(), line, root)
           for p in _sources() for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad


def test_every_module_imports_in_a_process_without_jax():
    """Walk every module in a fresh interpreter (this process has JAX loaded
    by ``conftest.py``) and check what ended up in ``sys.modules``; the
    kernel build directory must stay untouched."""
    code = f"""
import importlib, os, pkgutil, sys, tempfile
sys.path.insert(0, {str(ROOT)!r})
build = tempfile.mkdtemp()
os.environ["POLAR_LDPC_TORCH_BUILD_DIR"] = os.path.join(build, "kernels")
import polarcode_and_ldpc_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
assert not os.path.exists(os.environ["POLAR_LDPC_TORCH_BUILD_DIR"]), "import built something"
assert len(names) >= 31, names
for name in ("models.polar.adaptive", "models.ldpc.layered", "models.ldpc.qc",
             "ops.fastnode_cuda", "core.config", "sim.sweep", "sim.experiments",
             "utils.visualization", "cli._common", "cli.snr_curves"):
    assert pkg.__name__ + "." + name in names, name
print("walked", len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "walked" in out.stdout


def test_public_names():
    import polarcode_and_ldpc_tpu_torch as fec

    for name in fec.__all__:
        assert hasattr(fec, name), name
    for name in ("construct_polar_code", "PolarEncoder", "SCDecoder", "SCLDecoder",
                 "CASCLDecoder", "CRCCodec", "crc_encode", "crc_check", "AWGNChannel",
                 "LDPCEncoder", "BPDecoder", "MSDecoder", "NMSDecoder", "OMSDecoder",
                 "AdaptiveCASCLDecoder", "LayeredMSDecoder", "QCBPDecoder", "qc_base_matrix",
                 "qc_expand", "qc_ldpc_construction"):
        assert name in fec.__all__


def test_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    import numpy as np
    import torch

    import polarcode_and_ldpc_tpu_torch as fec
    from polarcode_and_ldpc_tpu_torch.cli import snr_curves
    from polarcode_and_ldpc_tpu_torch.sim import make_polar_pipeline

    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a CUDA device")
    frozen, _ = fec.construct_polar_code(32, 16, "bhattacharyya", 2.0)
    for build in (lambda: fec.SCDecoder(32, 16, frozen_bits=frozen),
                  lambda: fec.PolarEncoder(32, 16, frozen_bits=frozen),
                  lambda: fec.AWGNChannel(3.0),
                  lambda: fec.BPDecoder(np.eye(4, 8, dtype=np.int64)),
                  lambda: make_polar_pipeline(32, 16, frozen, 3.0),
                  lambda: fec.SCLDecoder(32, 16, frozen_bits=frozen),
                  lambda: fec.CASCLDecoder(32, 16, frozen_bits=frozen),
                  lambda: fec.CRCCodec(8),
                  lambda: fec.crc_encode(np.zeros(8, np.int8)),
                  lambda: fec.PolarEncoder(32, 16, frozen_bits=frozen, use_crc=True),
                  lambda: make_polar_pipeline(32, 16, frozen, 3.0, decoder="ca-scl"),
                  lambda: fec.AdaptiveCASCLDecoder(32, 16, frozen_bits=frozen),
                  lambda: fec.LayeredMSDecoder(np.eye(4, 8, dtype=np.int64)),
                  lambda: fec.QCBPDecoder(fec.qc_base_matrix(24, 12, 4, 3, 6, seed=0), 4),
                  lambda: fec.CASCLDecoder(32, 16, frozen_bits=frozen, control_impl="mega"),
                  lambda: fec.SCLDecoder(32, 16, frozen_bits=frozen, node_mode="fast"),
                  lambda: snr_curves.main(["--polar-n", "32", "--ldpc-n", "24", "--rates", "0.5",
                                           "--skip-plots", "--output-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_unported_options_raise_not_implemented():
    import numpy as np

    import polarcode_and_ldpc_tpu_torch as fec
    from polarcode_and_ldpc_tpu_torch.sim import make_ldpc_pipeline, make_polar_pipeline

    frozen, _ = fec.construct_polar_code(32, 16, "bhattacharyya", 2.0)
    # the list decoders are in the package now: the steps build and run
    import torch

    from polarcode_and_ldpc_tpu_torch.core import rng
    for dec in ("scl", "ca-scl"):
        step = make_polar_pipeline(32, 16, frozen, 3.0, decoder=dec, list_size=2, device="cpu")
        out = step(rng.prng_key(0), torch.arange(8))
        assert out["bit_errors"].shape == (8,) and out["frame_error"].dtype == torch.bool
    # what this package still leaves out says so, by name; JAX's scan controls
    # and the sort prune are in it now: the steps count what the default counts
    for kw in (dict(scl_control_impl="mega-interpret"), dict(scl_control_impl="kernel-interpret")):
        with pytest.raises(NotImplementedError, match=next(iter(kw.values()))):
            make_polar_pipeline(32, 16, frozen, 3.0, decoder="ca-scl", device="cpu", **kw)
    want = make_polar_pipeline(32, 16, frozen, 3.0, decoder="ca-scl", list_size=2,
                               device="cpu")(rng.prng_key(0), torch.arange(8))
    for kw in (dict(scl_control_impl="split"), dict(scl_control_impl="fused"),
               dict(scl_control_impl="kernel"), dict(scl_leaf_impl="sort")):
        got = make_polar_pipeline(32, 16, frozen, 3.0, decoder="ca-scl", list_size=2,
                                  device="cpu", **kw)(rng.prng_key(0), torch.arange(8))
        assert torch.equal(got["bit_errors"], want["bit_errors"]), kw
    # the fast list nodes are in the package now; the one-launch control has none
    step = make_polar_pipeline(32, 16, frozen, 3.0, decoder="ca-scl", list_size=2,
                               scl_node_mode="fast", device="cpu")
    assert step(rng.prng_key(0), torch.arange(8))["bit_errors"].shape == (8,)
    with pytest.raises(ValueError, match="mega"):
        make_polar_pipeline(32, 16, frozen, 3.0, decoder="ca-scl", scl_node_mode="fast",
                            scl_control_impl="mega", device="cpu")
    mask = np.zeros(32, bool)
    mask[frozen] = True
    from polarcode_and_ldpc_tpu_torch.models.polar import make_scl_decoder
    llr = torch.linspace(-3.0, 4.0, 8 * 32).reshape(8, 32)
    want = make_scl_decoder(32, mask, 2, device="cpu")(llr)
    for kw in (dict(perm_impl="onehot"), dict(impl="unrolled")):
        got = make_scl_decoder(32, mask, 2, device="cpu", **kw)(llr)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), kw
    with pytest.raises(NotImplementedError, match="scan"):
        make_scl_decoder(32, mask, 2, impl="scan", device="cpu")
    with pytest.raises(NotImplementedError):
        fec.SCDecoder(32, 16, frozen_bits=frozen, impl="scan", device="cpu")
    # the one-launch list control, the layered schedule and the quasi-cyclic
    # decoder are in the package now: the steps build and run
    step = make_polar_pipeline(32, 16, frozen, 3.0, decoder="ca-scl", list_size=2,
                               scl_control_impl="mega", device="cpu")
    assert step(rng.prng_key(0), torch.arange(8))["bit_errors"].shape == (8,)
    enc = fec.LDPCEncoder(24, 12, dv=3, dc=6, seed=1, device="cpu")
    step = make_ldpc_pipeline(enc.H, enc.G, 3.0, decoder="nms", schedule="layered", device="cpu")
    assert step(rng.prng_key(0), torch.arange(8))["iterations"].shape == (8,)
    base = fec.qc_base_matrix(24, 12, 4, 3, 6, seed=1)
    qenc = fec.LDPCEncoder(24, 12, H=fec.qc_expand(base, 4), device="cpu")
    step = make_ldpc_pipeline(qenc.H, qenc.G, 3.0, qc_base=base, z=4,
                              message_idx=qenc.info_positions, device="cpu")
    assert step(rng.prng_key(0), torch.arange(8))["iterations"].shape == (8,)
    for method in ("gallager", "peg"):
        with pytest.raises(NotImplementedError, match=method):
            fec.generate_ldpc_matrix(24, 12, method=method)
