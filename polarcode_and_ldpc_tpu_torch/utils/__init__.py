from .metrics import (calculate_ber, calculate_fer, calculate_throughput,
                      wilson_confidence_interval)

__all__ = ["calculate_ber", "calculate_fer", "calculate_throughput",
           "wilson_confidence_interval"]
