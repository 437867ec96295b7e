from .awgn import (AWGNChannel, awgn_capacity, awgn_noise_std, awgn_transmit,
                   bpsk_demodulate_hard, bpsk_modulate, symbols_to_llr)
from .bsc import BSCChannel, bsc_llr, bsc_transmit
from .fading import (RayleighFadingChannel, RicianFadingChannel, fading_apply,
                     rayleigh_transmit, rician_transmit)

__all__ = ["AWGNChannel", "BSCChannel", "RayleighFadingChannel", "RicianFadingChannel",
           "bpsk_modulate", "bpsk_demodulate_hard", "symbols_to_llr", "awgn_noise_std",
           "awgn_transmit", "awgn_capacity", "bsc_transmit", "rayleigh_transmit",
           "rician_transmit"]
