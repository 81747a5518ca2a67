"""fixmatmul — int8 x int8 -> int32 matmul with f32 scale vectors (paper C4).

  fixmatmul.py — the launch planner ``plan`` (streaming kernel at M <= 16,
                 tiled above), build (nvcc, sm_90a), ctypes binding and
                 launch wrapper ``fixmatmul`` (CUDA tensors -> kernel; CPU ->
                 plain version);
  ops.py       — ``quantized_matmul`` (per-row activation quantization +
                 the kernel) and ``quantize_weight``;
  ref.py       — the plain version ``fixmatmul_ref``;
  csrc/        — ``fixmatmul.cu``, the two kernels.
"""

from repro_torch.kernels.fixmatmul.fixmatmul import fixmatmul
from repro_torch.kernels.fixmatmul.ops import quantize_weight, quantized_matmul
from repro_torch.kernels.fixmatmul.ref import fixmatmul_ref

__all__ = ["fixmatmul", "fixmatmul_ref", "quantized_matmul", "quantize_weight"]
