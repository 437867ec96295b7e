from .awgn import (AWGNChannel, awgn_capacity, awgn_noise_std, awgn_transmit,
                   bpsk_demodulate_hard, bpsk_modulate, symbols_to_llr)

__all__ = ["AWGNChannel", "awgn_capacity", "awgn_noise_std", "awgn_transmit",
           "bpsk_demodulate_hard", "bpsk_modulate", "symbols_to_llr"]
