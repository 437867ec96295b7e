"""Hand-written CUDA kernels and their wrappers.

Each wrapper keeps a count of the launches it made (``launch_counts``), so a
run can show that it went through the kernels.  Importing this package builds
nothing; kernels are compiled at first use (``ops/build.py``).
"""

from __future__ import annotations

# the LDPC kernel counts its two check rules and its layered schedule apart,
# the list kernels their exact and fast node programs: they are distinct code
# paths
_LAUNCHES = {"sc_decode": 0, "bp_decode_bp": 0, "bp_decode_ms": 0,
             "bp_decode_layered": 0, "scl_chunk_body": 0, "scl_chunk_step": 0,
             "scl_last_chunk": 0, "scl_decode_mega": 0, "scl_chunk_body_fast": 0,
             "scl_chunk_step_fast": 0, "scl_last_chunk_fast": 0, "fastnode_select": 0}


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0
