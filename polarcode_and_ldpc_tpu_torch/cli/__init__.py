"""Command-line entry points (``python -m polarcode_and_ldpc_tpu_torch.cli.<name>``):

* ``run_benchmark`` — BER / FER of a polar and an LDPC code over an SNR range
  and a channel, then the throughput probes and the complexity counts;
* ``throughput`` — the throughput probes alone;
* ``code_params`` — code-length and code-rate sweeps;
* ``sc_vs_scl`` — SC against SCL at each list size;
* ``snr_curves`` — the multi-rate polar vs LDPC SNR-curve study.
"""
