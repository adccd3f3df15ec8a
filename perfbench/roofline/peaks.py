"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  The configurations state float32
with TF32 off, so the model's share of peak is against float32 outside
the tensor cores."""

FP32_FLOPS = 67e12  # FLOP/s, float32 without tensor cores
HBM_BYTES = 3.35e12  # bytes/s


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES)
