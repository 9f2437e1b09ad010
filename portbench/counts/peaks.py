"""NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit
(copied from ``asr_chinese_e2e_tpu_torch/bench.py``)."""

H100_SXM_BF16_PEAK = 989.4e12  # FLOP/s, bf16 tensor cores
H100_SXM_F32_PEAK = 67e12  # FLOP/s, f32 outside the tensor cores
H100_SXM_BYTES_PER_S = 3.35e12  # HBM3


def peak_flops(dtype: str) -> float:
    """The dense peak for a step in ``dtype``."""
    return H100_SXM_BF16_PEAK if dtype == "bfloat16" else H100_SXM_F32_PEAK
