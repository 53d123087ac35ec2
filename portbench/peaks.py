"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W),
the roofline's denominators."""

HBM_BYTES_PER_S = 3.35e12
# the integer ALU pipe: 64 INT32 lanes per SM per clock (half its 128 FP32
# lanes), 132 SMs at the 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound_s(nbytes: int, ops: int = 0) -> float:
    """The least time the card could take: each byte moved once at HBM
    bandwidth, or the integer operations at the ALU pipe's rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
