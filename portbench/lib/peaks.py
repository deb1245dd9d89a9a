"""The card's published peaks (NVIDIA H100 SXM data sheet, dense rates,
at its 700 W power limit), which every share of a roofline or of the
peak is taken against."""

#: bf16 / fp16 tensor-core FLOP/s
BF16_FLOPS = 989e12
#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12
#: bytes of device memory
HBM_BYTES = 80e9


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card needs for the work: operations over the
    bf16 peak or bytes over the memory rate, the larger."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
