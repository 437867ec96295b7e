"""Loader for the oracle-schema fixture.

The reference's production runs take their code construction from the
third-party oracles: a ``polarcodes`` frozen set and a ``pyldpc`` (H, G)
pair.  Where the libraries are installed, ``PolarLibWrapper`` /
``LDPCLibWrapper`` provide those live; this module loads the same artifacts
from the repository's committed fixture
(``tests/fixtures/oracle_schema_fixture.json``), so the oracle → framework
path runs where the libraries are absent.  The file is read where it lies
in the checkout, not copied into the package.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path

import numpy as np

DEFAULT_FIXTURE = (Path(__file__).resolve().parents[2] / "tests" / "fixtures"
                   / "oracle_schema_fixture.json")


def _unpack(d: dict) -> np.ndarray:
    raw = np.frombuffer(base64.b64decode(d["packed_bits_b64"]), np.uint8)
    total = int(np.prod(d["shape"]))
    return np.unpackbits(raw, count=total).reshape(d["shape"]).astype(np.int64)


def load_oracle_fixture(path=DEFAULT_FIXTURE) -> dict:
    """The fixture with its arrays decoded:

    ``{"polar": {"N", "K", "design_snr_db", "frozen_positions [N-K]"},
    "ldpc": {"n", "dv", "dc", "k_actual", "H [m, n]", "G_nk [n, k_actual]"}}``
    — the shapes and orientations the oracle wrappers emit (pyldpc's G is
    (n, k); ``LDPCEncoder`` transposes it).
    """
    d = json.loads(Path(path).read_text())
    d["polar"]["frozen_positions"] = np.asarray(d["polar"]["frozen_positions"], np.int64)
    d["ldpc"]["H"] = _unpack(d["ldpc"]["H"])
    d["ldpc"]["G_nk"] = _unpack(d["ldpc"]["G_nk"])
    return d
