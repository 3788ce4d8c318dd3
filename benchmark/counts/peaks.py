"""Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity, at its 700 W power limit): the table every roofline share and
every `mfu` of the benchmark divides by."""

BYTES_PER_S = 3.35e12  # HBM3
OPS_PER_S = {
    "float32": 67e12,  # outside the tensor cores
    "tf32": 495e12,
    "bfloat16": 989e12,
    "int8": 1979e12,
}
DEVICE_KIND = "NVIDIA H100 80GB HBM3"


def least_seconds(n_bytes: float, ops: float, precision: str) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate of `precision`."""
    return max(n_bytes / BYTES_PER_S, ops / OPS_PER_S[precision])
