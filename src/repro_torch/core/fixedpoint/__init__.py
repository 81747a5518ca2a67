from repro_torch.core.fixedpoint.luts import (
    LOG10_LUT,
    SGLUT13,
    SGLUT310,
    fplog10,
    fpsigmoid,
    fpsigmoid_interp,
    fpsigmoid_interp_t,
    fpsin,
    fpsqrt,
    fprelu,
    fplog10_t,
    fpsigmoid_t,
    fpsin_t,
    fpsqrt_t,
)
from repro_torch.core.fixedpoint.fxp import (
    apply_scale,
    apply_scale_t,
    quantize_per_channel,
)

__all__ = [
    "LOG10_LUT", "SGLUT13", "SGLUT310",
    "fplog10", "fpsigmoid", "fpsigmoid_interp", "fpsin", "fpsqrt", "fprelu",
    "fplog10_t", "fpsigmoid_t", "fpsigmoid_interp_t", "fpsin_t", "fpsqrt_t",
    "apply_scale", "apply_scale_t", "quantize_per_channel",
]
