"""Hand-written CUDA kernels and their wrappers.

Each wrapper keeps a count of the launches it made (``launch_counts``), so a
run can show that it went through the kernels.  Importing this package builds
nothing; kernels are compiled at first use (``ops/build.py``).
"""

from __future__ import annotations

# every mode of a kernel is a distinct code path and counts apart: the SC
# kernel whole or on a hybrid subtree; the LDPC kernel's two check rules and
# its layered schedule; the list kernels' exact and fast node programs, the
# live width's narrow prefix (its narrow chunk steps in one launch), and
# their one-hot permutation modes, the wide-list instances of the list kernels
# (32 < L <= 64, "_wide") and the XL-list ones (64 < L <= 256, "_xl"); and,
# for the LDPC and list kernels, the mode whose working set lives in device
# memory ("_devmem"); the one-launch
# list decode with its step table in device memory ("scl_decode_mega_long")
_BASES = ("sc_decode", "sc_decode_sub", "bp_decode_bp", "bp_decode_ms", "bp_decode_layered",
          "scl_chunk_body", "scl_chunk_step", "scl_last_chunk", "scl_chunk_body_fast",
          "scl_chunk_step_fast", "scl_last_chunk_fast", "scl_narrow_prefix",
          "scl_chunk_body_onehot", "scl_chunk_step_onehot", "scl_last_chunk_onehot",
          "scl_chunk_body_wide", "scl_chunk_step_wide", "scl_narrow_prefix_wide",
          "scl_last_chunk_wide", "scl_chunk_body_xl", "scl_chunk_step_xl",
          "scl_narrow_prefix_xl", "scl_last_chunk_xl")
_LAUNCHES = {name: 0 for base in _BASES
             for name in ((base,) if base.startswith("sc_decode") else (base, base + "_devmem"))}
_LAUNCHES.update(scl_decode_mega=0, scl_decode_mega_long=0, fastnode_select=0,
                 sublane_roll=0)


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0
