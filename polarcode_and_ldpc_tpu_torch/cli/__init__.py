"""Command-line entry points:

* ``python -m polarcode_and_ldpc_tpu_torch.cli.snr_curves`` — the multi-rate
  polar vs LDPC SNR-curve study.
"""
