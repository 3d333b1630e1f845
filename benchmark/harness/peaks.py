"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at its
700 W limit) and the roofline bound of a kernel call."""

HBM_BYTES_S = 3.35e12       # device memory bytes/s
BF16_OPS_S = 989e12         # bf16 tensor-core operations/s
F32_OPS_S = 67e12           # float32 operations/s outside the tensor cores


def bound_s(n_bytes: float, bf16_ops: float = 0.0, f32_ops: float = 0.0
            ) -> float:
    """The least time the card could take: the larger of the bytes over
    device memory's rate and the operations over their type's peak."""
    return max(n_bytes / HBM_BYTES_S, bf16_ops / BF16_OPS_S,
               f32_ops / F32_OPS_S)


def mlp_ops(shapes) -> int:
    """Operations per sample of a bias-free MLP of (in, out) layer shapes:
    a multiply and an add per weight."""
    return sum(2 * a * b for a, b in shapes)
