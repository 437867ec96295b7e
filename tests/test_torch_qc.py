"""Port quasi-cyclic LDPC against the JAX package: the shift-matrix
constructions (same seeds, same matrices), the roll-based decoder (flooding
BP / min-sum and the layered schedule) against JAX's and against the port's
generic decoder on the expanded H, and a Monte-Carlo step of the QC pipeline
in both packages.

Tolerances: min-sum in either schedule is exact arithmetic, so bits and
iteration counts are equal.  Sum-product in float32 goes through two runtimes'
``tanh`` / ``log1p``: the messages differ in the last bits, bits and iteration
counts agree on these seeded inputs (as for the generic decoder); in float64
the comparison is on equal bits and iteration counts too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu.models.ldpc import matrix as jmat
from polarcode_and_ldpc_tpu.models.ldpc import qc as jqc
from polarcode_and_ldpc_tpu.sim import pipelines as jpipes
from polarcode_and_ldpc_tpu_torch import convert
from polarcode_and_ldpc_tpu_torch.core import rng
from polarcode_and_ldpc_tpu_torch.models.ldpc import matrix as tmat
from polarcode_and_ldpc_tpu_torch.models.ldpc import qc as tqc
from polarcode_and_ldpc_tpu_torch.sim import pipelines as tpipes

N, K, Z = 96, 48, 8
VARIANTS = {"bp": {}, "ms": {}, "nms": {"normalization": 0.75}, "oms": {"offset": 0.5}}
TDT = {"f32": torch.float32, "f64": torch.float64}
JDT = {"f32": jnp.float32, "f64": jnp.float64}


def _llrs(B, n, seed, snr_db, dtype):
    std = np.sqrt(1.0 / (2.0 * 10 ** (snr_db / 10.0)))
    z = np.random.default_rng(seed).standard_normal((B, n))
    llr = (2.0 * (1.0 + std * z) / std ** 2).astype(dtype)
    llr[0, :3] = 0.0
    return llr


@pytest.fixture(scope="module")
def base():
    return tmat.qc_base_matrix(N, K, Z, 3, 6, seed=42)


@pytest.mark.parametrize("n,k,z,seed", [(96, 48, 8, 42), (96, 48, 16, 0), (192, 96, 8, 3),
                                        (8192, 4096, 512, 42)])
def test_qc_matrices_equal_jax(n, k, z, seed):
    tb, jb = tmat.qc_base_matrix(n, k, z, 3, 6, seed), jmat.qc_base_matrix(n, k, z, 3, 6, seed)
    assert tb.dtype == np.int64 and np.array_equal(tb, jb)
    assert ((tb >= 0).sum(axis=0) == 3).all() and ((tb >= 0).sum(axis=1) == 6).all()
    if n <= 192:
        H = tmat.qc_expand(tb, z)
        assert np.array_equal(H, jmat.qc_expand(jb, z))
        assert np.array_equal(H, tmat.qc_ldpc_construction(n, k, z, 3, 6, seed))
        assert np.array_equal(H, tmat.generate_ldpc_matrix(n, k, "qc", 3, 6, seed, z))
        assert np.array_equal(jmat.generate_ldpc_matrix(n, k, "qc", 3, 6, seed),
                              tmat.generate_ldpc_matrix(n, k, "qc_ldpc", 3, 6, seed))
    with pytest.raises(ValueError, match="must divide"):
        tmat.qc_base_matrix(n, k, 7, 3, 6, seed)


def test_base_edges_equal_jax(base):
    assert tqc._base_edges(base) == jqc._base_edges(base)


@pytest.mark.parametrize("dt,early", [("f32", True), ("f32", False), ("f64", True)])
@pytest.mark.parametrize("variant,schedule", [("bp", "flooding"), ("ms", "flooding"),
                                              ("nms", "flooding"), ("oms", "flooding"),
                                              ("ms", "layered"), ("nms", "layered"),
                                              ("oms", "layered")])
def test_qc_decoder_equals_jax(base, variant, schedule, dt, early):
    kw = VARIANTS[variant]
    llr = np.concatenate([_llrs(20, N, 3, -1.0, JDT[dt]), _llrs(20, N, 4, 2.0, JDT[dt])])
    jd = jax.jit(jqc.make_qc_bp_decoder(base, Z, 12, early, JDT[dt], variant,
                                        schedule=schedule, **kw))
    td = tqc.make_qc_bp_decoder(base, Z, 12, early, TDT[dt], variant, schedule=schedule,
                                device="cpu", **kw)
    wb, wi = jd(llr)
    gb, gi = td(torch.from_numpy(llr))
    assert gb.dtype == torch.int8 and gi.dtype == torch.int32
    assert np.array_equal(np.asarray(wb), gb.numpy())
    assert np.array_equal(np.asarray(wi), gi.numpy())
    if early:
        assert len(set(gi.tolist())) > 2


@pytest.mark.parametrize("variant,schedule", [("bp", "flooding"), ("nms", "flooding"),
                                              ("oms", "flooding"), ("nms", "layered"),
                                              ("oms", "layered")])
def test_qc_decoder_equals_generic_decoder_on_expanded_H(base, variant, schedule):
    """The roll path and the gather path are the same float program: bits and
    iteration counts equal in float32, sum-product included."""
    kw = VARIANTS[variant]
    H = tmat.qc_expand(base, Z)
    qc = tfec.QCBPDecoder(base, Z, 12, variant=variant, schedule=schedule, device="cpu", **kw)
    assert np.array_equal(qc.H, H) and (qc.n, qc.m, qc.mb, qc.nb) == (N, N - K, 6, 12)
    if schedule == "layered":
        generic = tfec.LayeredMSDecoder(H, 12, num_layers=base.shape[0], device="cpu", **kw)
    elif variant == "bp":
        generic = tfec.BPDecoder(H, 12, device="cpu")
    else:
        generic = tfec.MSDecoder(H, 12, device="cpu", **kw)
    llr = np.concatenate([_llrs(24, N, 5, -1.0, np.float32), _llrs(24, N, 6, 2.0, np.float32)])
    qb, qi = qc.decode(llr, return_iterations=True)
    gb, gi = generic.decode(llr, return_iterations=True)
    assert torch.equal(qb, gb) and torch.equal(qi, gi)
    assert qc.decode(llr[1]).shape == (N,)


def test_qc_class_equals_jax_and_errors(base):
    jd = jfec.QCBPDecoder(base, Z, max_iter=10, variant="nms", normalization=0.75)
    td = tfec.QCBPDecoder(base, Z, max_iter=10, variant="nms", normalization=0.75, device="cpu")
    assert repr(td) == repr(jd)
    llr = _llrs(16, N, 9, 0.0, np.float32)
    wb, wi = jd.decode(llr, return_iterations=True)
    gb, gi = td.decode(llr, return_iterations=True)
    assert np.array_equal(np.asarray(wb), gb.numpy()) and np.array_equal(np.asarray(wi), gi.numpy())
    with pytest.raises(ValueError, match="min-sum only"):
        tfec.QCBPDecoder(base, Z, variant="bp", schedule="layered", device="cpu")
    with pytest.raises(ValueError, match="unknown QC BP variant"):
        tfec.QCBPDecoder(base, Z, variant="spa", device="cpu")
    irregular = base.copy()
    irregular[0, np.nonzero(base[0] >= 0)[0][0]] = -1
    with pytest.raises(ValueError, match="regular base graph"):
        tfec.QCBPDecoder(irregular, Z, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfec.QCBPDecoder(base, Z)


@pytest.mark.parametrize("name,schedule", [("bp", "flooding"), ("nms", "layered")])
def test_qc_ldpc_step_equals_jax(base, name, schedule):
    """256 frames of the QC pipeline (n=96) on the same key and frame ids; at
    most 1 frame in 256 may differ (float32 noise agrees to 1e-6)."""
    code = convert.qc_code_from_numpy(base, Z, device="cpu")
    enc = code["encoder"]
    kw = dict(decoder=name, max_iter=10, schedule=schedule, message_idx=enc.info_positions,
              qc_base=base, z=Z, **({"normalization": 0.75} if name == "nms" else {}))
    jstep = jax.jit(jpipes.make_ldpc_pipeline(enc.H, enc.G, -1.0, **kw))
    tstep = tpipes.make_ldpc_pipeline(enc.H, enc.G, -1.0, device="cpu", rng_x64=True, **kw)
    ids = np.arange(300, 300 + 256)
    want = jstep(jax.random.PRNGKey(2), jnp.asarray(ids, jnp.uint32))
    got = tstep(rng.prng_key(2), torch.from_numpy(ids))
    differ = np.nonzero((np.asarray(want["bit_errors"]) != got["bit_errors"].numpy())
                        | (np.asarray(want["iterations"]) != got["iterations"].numpy()))[0]
    print(f"frames that differ: {differ.tolist()} of 256")
    assert differ.size <= 1, differ
    assert int(got["bit_errors"].sum()) > 0
