"""Port adaptive SC-first CA-SCL against the JAX package: the four cases of
the JAX package's own adaptive tests (semantics, all-pass, error rate against
CA-SCL, budget overflow with a tiny budget) on the same LLRs through both
packages at N=128, K=64, L=4.

Decoded arrays and stats must be equal: the SC pass is exact min-sum
arithmetic, the CRC is integer, and the list decoder's paths agree on every
seeded case (its float32 metrics differ between the two runtimes in the last
bit, see ``test_torch_scl.py``; no selection here depends on that bit).
"""

import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu_torch import ops

N, K, L = 128, 64, 4


@pytest.fixture(scope="module")
def code():
    frozen, _ = tfec.construct_polar_code(N, K, "bhattacharyya", 2.0)
    enc = tfec.PolarEncoder(N, K, frozen_bits=frozen, use_crc=True, device="cpu")
    return frozen, enc


@pytest.fixture(scope="module")
def jax_adaptive(code):
    frozen, _ = code
    return jfec.AdaptiveCASCLDecoder(N, K, list_size=L, frozen_bits=frozen, fallback_batch=16)


def _llrs(enc, frames, snr_db, seed):
    """Seeded numpy messages and noise through the port's encoder."""
    g = np.random.default_rng(seed)
    msgs = g.integers(0, 2, (frames, enc.K_data))
    std = np.sqrt(1.0 / (2.0 * 10 ** (snr_db / 10.0)))
    y = 1.0 - 2.0 * enc.encode(msgs).numpy().astype(np.float64) + std * g.standard_normal((frames, N))
    return msgs, (2.0 * y / std ** 2).astype(np.float32)


def _port(frozen, **kw):
    return tfec.AdaptiveCASCLDecoder(N, K, list_size=L, frozen_bits=frozen, device="cpu", **kw)


def test_adaptive_semantics_equal_jax(code, jax_adaptive):
    """SC-passing frames return the SC result, failing frames CA-SCL's; the
    port's output and stats equal the JAX decoder's."""
    frozen, enc = code
    msgs, llr = _llrs(enc, 200, -1.0, seed=5)
    ada = _port(frozen, fallback_batch=16)
    assert (ada.sc_impl, ada.scl_control_impl) == ("unrolled", "unroll-fused")
    assert repr(ada) == repr(jax_adaptive)
    before = ops.launch_counts()
    out, stats = ada.decode(llr, return_stats=True)
    assert ops.launch_counts() == before  # on the CPU nothing launches
    want, jstats = jax_adaptive.decode(llr, return_stats=True)
    assert out.dtype == torch.int8 and np.array_equal(out.numpy(), np.asarray(want))
    assert stats == jstats and 0 < stats["sc_passed"] < 200  # both paths exercised
    sc = tfec.SCDecoder(N, K, frozen_bits=frozen, device="cpu").decode(llr)
    ca = tfec.CASCLDecoder(N, K, L, frozen_bits=frozen, device="cpu").decode(llr)
    ok = tfec.crc_check(sc, device="cpu")
    assert int((~ok).sum()) == stats["scl_fallbacks"]
    assert torch.equal(out, torch.where(ok[:, None], sc, ca))
    one = ada.decode(llr[3])
    assert one.shape == (1, K) and torch.equal(one[0], out[3])


def test_adaptive_all_pass_skips_the_list_decoder(code, jax_adaptive, monkeypatch):
    frozen, enc = code
    msgs, llr = _llrs(enc, 64, 8.0, seed=2)
    ada = _port(frozen)
    monkeypatch.setattr(ada, "_scl_pass", lambda llr: pytest.fail("list decoder ran"))
    out, stats = ada.decode(llr, return_stats=True)
    want, jstats = jax_adaptive.decode(llr, return_stats=True)
    assert stats == jstats and stats["scl_fallbacks"] == 0 and stats["sc_pass_rate"] == 1.0
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert np.array_equal(out[:, :enc.K_data].numpy(), msgs)


def test_adaptive_error_rate_matches_cascl(code, jax_adaptive):
    frozen, enc = code
    msgs, llr = _llrs(enc, 300, 2.0, seed=9)
    out = _port(frozen).decode(llr)
    assert np.array_equal(out.numpy(), np.asarray(jax_adaptive.decode(llr)))
    ca = tfec.CASCLDecoder(N, K, L, frozen_bits=frozen, device="cpu").decode(llr)
    fer_ada = (out[:, :enc.K_data].numpy() != msgs).any(axis=1).mean()
    fer_ca = (ca[:, :enc.K_data].numpy() != msgs).any(axis=1).mean()
    # adaptive may only differ on frames where SC already found a CRC-valid
    # codeword, so the two FERs are statistically indistinguishable
    assert abs(fer_ada - fer_ca) <= 0.02


@pytest.fixture(scope="module")
def overflow_case(code):
    """120 frames at −2 dB through the JAX decoder with a budget of 4."""
    frozen, enc = code
    msgs, llr = _llrs(enc, 120, -2.0, seed=3)
    jtiny = jfec.AdaptiveCASCLDecoder(N, K, list_size=L, frozen_bits=frozen, fallback_batch=8,
                                      fallback_budget=4)
    return llr, jtiny.decode(llr, return_stats=True)


@pytest.mark.parametrize("control", [None, "mega"])
def test_adaptive_budget_overflow_residue_equals_jax(code, overflow_case, control):
    """More CRC failures than the budget: the residue re-decodes in
    ``fallback_batch`` slices with identical outputs."""
    frozen, enc = code
    llr, (out_j, st_j) = overflow_case
    tiny = _port(frozen, fallback_batch=8, fallback_budget=4, scl_control_impl=control)
    ref = _port(frozen)
    out_t, st_t = tiny.decode(llr, return_stats=True)
    out_r, st_r = ref.decode(llr, return_stats=True)
    assert st_t == st_j
    assert st_t["scl_fallbacks"] == st_r["scl_fallbacks"] > 4
    assert st_t["budget_overflow"] == st_t["scl_fallbacks"] - 4 and st_r["budget_overflow"] == 0
    assert torch.equal(out_t, out_r) and np.array_equal(out_t.numpy(), np.asarray(out_j))


def test_adaptive_options(code):
    frozen, enc = code
    assert _port(frozen)._budget(8192) == 512 and _port(frozen)._budget(100) == 100
    assert _port(frozen, fallback_budget=4)._budget(100) == 4
    # the fast list nodes are in the package (equal to JAX: test_torch_fast_nodes.py);
    # the one-launch list control has none
    assert _port(frozen, scl_node_mode="fast").scl_control_impl == "unroll-fused"
    with pytest.raises(ValueError, match="mega"):
        _port(frozen, scl_node_mode="fast", scl_control_impl="mega")
    # JAX's default list control "split" is in the package: the same outputs
    split = _port(frozen, scl_control_impl="split")
    assert split.scl_control_impl == "split"
    _, llr = _llrs(enc, 48, -2.0, seed=5)
    out_s, st_s = split.decode(llr, return_stats=True)
    out_d, st_d = _port(frozen).decode(llr, return_stats=True)
    assert st_s == st_d and st_s["scl_fallbacks"] > 0 and torch.equal(out_s, out_d)
    with pytest.raises(NotImplementedError, match="kernel-interpret"):
        _port(frozen, scl_control_impl="kernel-interpret")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfec.AdaptiveCASCLDecoder(N, K, list_size=L, frozen_bits=frozen)
