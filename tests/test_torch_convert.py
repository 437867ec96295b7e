"""State carried across from the JAX package (as numpy arrays): every decoder
built from converted state gives the outputs of the one built by the port's
own constructors."""

import jax
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu.models.ldpc.graph import TannerGraph as JaxTannerGraph
from polarcode_and_ldpc_tpu_torch import convert
from polarcode_and_ldpc_tpu_torch.core import rng
from polarcode_and_ldpc_tpu_torch.models.ldpc.bp import make_bp_decoder
from polarcode_and_ldpc_tpu_torch.models.ldpc.graph import TABLE_NAMES, TannerGraph
from polarcode_and_ldpc_tpu_torch.models.ldpc.minsum import make_ms_decoder
from polarcode_and_ldpc_tpu_torch.models.polar.sc import make_sc_decoder
from polarcode_and_ldpc_tpu_torch.sim import make_ldpc_pipeline


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


def _llr(shape, seed, scale=2.0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape) * scale + 1.0)


@pytest.mark.parametrize("give", ["mask", "positions"])
def test_polar_code_from_numpy(give):
    N, K = 128, 64
    jd = jfec.SCDecoder(N, K, frozen_bits=jfec.construct_polar_code(N, K, "bhattacharyya", 2.0)[0])
    if give == "mask":
        code = convert.polar_code_from_numpy(N, frozen_mask=np.asarray(jd.frozen_mask))
    else:
        code = convert.polar_code_from_numpy(N, frozen_bits=np.asarray(jd.frozen_bits))
    assert code["K"] == K
    assert np.array_equal(code["frozen_bits"], jd.frozen_bits)
    assert np.array_equal(code["info_bits"], jd.info_bits)
    own = tfec.SCDecoder(N, K, frozen_bits=tfec.construct_polar_code(N, K, "bhattacharyya", 2.0)[0],
                         dtype=torch.float64, device="cpu")
    conv = make_sc_decoder(N, code["frozen_mask"], torch.float64, device="cpu")
    llr = _llr((16, N), 1)
    assert torch.equal(own.decode_full(llr), conv(llr))
    assert np.array_equal(np.asarray(jd.decode_full(llr.numpy())), conv(llr).numpy())
    with pytest.raises(ValueError):
        convert.polar_code_from_numpy(N)


def test_ldpc_code_from_numpy():
    je = jfec.LDPCEncoder(96, 48, dv=3, dc=6, seed=42)
    te = convert.ldpc_code_from_numpy(np.asarray(je.H), np.asarray(je.G),
                                      np.asarray(je.info_positions), device="cpu")
    own = tfec.LDPCEncoder(96, 48, dv=3, dc=6, seed=42, device="cpu")
    msgs = np.random.default_rng(3).integers(0, 2, (10, 48))
    cw = te.encode(msgs)
    assert torch.equal(cw, own.encode(msgs))
    assert np.array_equal(cw.numpy(), np.asarray(je.encode(msgs)))
    assert np.array_equal(te.extract_message(cw).numpy(), msgs)
    assert np.array_equal(te.info_positions, own.info_positions)


def test_qc_code_from_numpy():
    """The QC code state carried across: base and lift size give the port's
    encoder (H, G, message positions as the JAX encoder derives them) and the
    pipeline inputs; decoders built from it equal the JAX decoder on the
    same base (min-sum: bits and iteration counts)."""
    from polarcode_and_ldpc_tpu.models.ldpc import matrix as jmat

    N, K, Z = 96, 48, 8
    base = jmat.qc_base_matrix(N, K, Z, 3, 6, seed=42)
    jenc = jfec.LDPCEncoder(N, K, H=jmat.qc_expand(base, Z))
    code = convert.qc_code_from_numpy(base, Z, np.asarray(jenc.G), np.asarray(jenc.info_positions),
                                      device="cpu")
    enc = code["encoder"]
    assert np.array_equal(code["H"], jmat.qc_expand(base, Z))
    assert np.array_equal(enc.H, np.asarray(jenc.H)) and np.array_equal(enc.G, np.asarray(jenc.G))
    assert np.array_equal(enc.info_positions, np.asarray(jenc.info_positions))
    assert np.array_equal(code["qc_base"], base) and code["z"] == Z
    msgs = np.random.default_rng(2).integers(0, 2, (12, K))
    cw = enc.encode(msgs)
    assert np.array_equal(cw.numpy(), np.asarray(jenc.encode(msgs)))
    own = convert.qc_code_from_numpy(base, Z, device="cpu")  # derives its own generator
    assert own["encoder"].verify_codeword(own["encoder"].encode(msgs)).all()
    with pytest.raises(ValueError, match="2-D"):
        convert.qc_code_from_numpy(base[0], Z, device="cpu")
    llr = _llr((16, N), 4).to(torch.float32)
    td = tfec.QCBPDecoder(code["qc_base"], code["z"], 10, variant="nms", normalization=0.75,
                          device="cpu")
    jd = jfec.QCBPDecoder(base, Z, 10, variant="nms", normalization=0.75)
    gb, gi = td.decode(llr, return_iterations=True)
    wb, wi = jd.decode(llr.numpy(), return_iterations=True)
    assert np.array_equal(np.asarray(wb), gb.numpy()) and np.array_equal(np.asarray(wi), gi.numpy())
    step = make_ldpc_pipeline(code["H"], enc.G, -1.0, decoder="nms", normalization=0.75,
                              max_iter=10, message_idx=enc.info_positions,
                              qc_base=code["qc_base"], z=code["z"], device="cpu")
    out = step(rng.prng_key(0), torch.arange(32))
    assert out["bit_errors"].shape == (32,) and out["iterations"].dtype == torch.int32


@pytest.mark.parametrize("method", ["regular", "mackay"])
def test_tanner_graph_from_numpy(method):
    je = jfec.LDPCEncoder(96, 48, dv=3, dc=6, seed=5, method=method)
    jg = JaxTannerGraph.from_H(je.H)
    tables = {name: np.asarray(getattr(jg, name)) for name in TABLE_NAMES}
    conv = convert.tanner_graph_from_numpy(tables, device="cpu")
    own = TannerGraph.from_H(je.H, device="cpu")
    assert (conv.m, conv.n, conv.dc_max, conv.dv_max, conv.num_edges) == (
        jg.m, jg.n, jg.dc_max, jg.dv_max, jg.num_edges)
    for name in TABLE_NAMES:
        assert torch.equal(getattr(conv, name), getattr(own, name)), name
    llr = _llr((12, 96), 2, scale=3.0)
    for make in (lambda g: make_bp_decoder(g, 10, True, torch.float64),
                 lambda g: make_ms_decoder(g, 10, 0.75, 0.0, True, torch.float64)):
        (b1, i1), (b2, i2) = make(conv)(llr), make(own)(llr)
        assert torch.equal(b1, b2) and torch.equal(i1, i2)
    with pytest.raises(KeyError):
        convert.tanner_graph_from_numpy({"check_vars": tables["check_vars"]}, device="cpu")


def test_key_from_numpy():
    for seed in (0, 42, 2**33 + 1):
        data = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
        key = convert.key_from_numpy(data, device="cpu")
        assert torch.equal(key, rng.prng_key(seed))
        assert np.array_equal(rng.key_words(key), data)
    with pytest.raises(ValueError):
        convert.key_from_numpy(np.zeros(3, np.uint32), device="cpu")


def test_pipeline_from_converted_state_equals_own():
    je = jfec.LDPCEncoder(96, 48, dv=3, dc=6, seed=42)
    te = tfec.LDPCEncoder(96, 48, dv=3, dc=6, seed=42, device="cpu")
    kw = dict(decoder="nms", normalization=0.75, max_iter=10, device="cpu")
    a = make_ldpc_pipeline(np.asarray(je.H), np.asarray(je.G), 1.0,
                           message_idx=np.asarray(je.info_positions), **kw)
    b = make_ldpc_pipeline(te.H, te.G, 1.0, message_idx=te.info_positions, **kw)
    key = convert.key_from_numpy(np.asarray(jax.random.key_data(jax.random.PRNGKey(1))), "cpu")
    ids = torch.arange(64)
    ra, rb = a(key, ids), b(rng.prng_key(1), ids)
    for name in ("bit_errors", "frame_error", "iterations"):
        assert torch.equal(ra[name], rb[name])
