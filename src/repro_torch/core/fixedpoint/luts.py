"""Fixed-point LUT numerics — faithful implementation of paper §4.2.

``fplog10`` / ``fpsigmoid`` follow Alg. 2 exactly (same segment boundaries,
same index arithmetic); the LUTs are generated with Alg. 3 / Eq. 3.  The
paper's accuracy claim (<1 % sigmoid error, Fig. 11) is asserted in tests and
reproduced in ``benchmarks/bench_lut.py``.

Scales (paper Tab. 4):
  - sigmoid/sin/relu: x and y scale 1:1000
  - log10:            x scale 1:10, y scale 1:1000 in the VM word (the
                      internal ``fplog10`` helper uses y scale 1:100 as in
                      Alg. 2; the VM word multiplies by 10)

Two implementations of each function are provided:
  - plain-Python/NumPy scalar (mirrors the C code 1:1)
  - vectorized torch on int32 tensors (the batched interpreter's forms; the
    ``_t`` names).  They transliterate the reference's jnp forms operation
    for operation, int32 wraparound included, so they are bit-exact with
    them over the whole int32 range (tests/test_torch_host.py).

This is the PyTorch port's copy of ``repro.core.fixedpoint.luts``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# LUT construction (paper Eq. 3 + Alg. 3)
# ---------------------------------------------------------------------------

# log10lut[i] = int(log10((i+10)/10) * 100) for normalized x in [10, 99].
LOG10_LUT = np.array(
    [int(math.log10(x / 10.0) * 100.0) for x in range(10, 100)], dtype=np.int32
)


def fplog10(x: int) -> int:
    """Alg. 2 fplog10: x scale 1:10, result scale 1:100.  x must be >= 10."""
    x = int(x)
    if x < 10:
        # Out of the paper's intended domain; clamp (callers guarantee >= 10).
        x = 10
    shift = 0
    while x >= 100:
        shift += 1
        x //= 10
    return shift * 100 + int(LOG10_LUT[x - 10])


def _build_sigmoid_luts() -> tuple[np.ndarray, np.ndarray]:
    """Alg. 3: derive the two segment LUTs through fplog10 itself."""
    sglut13 = {}
    x = 1.0
    while x <= 2.95 + 1e-9:
        i10 = fplog10(int(x * 1000 / 5)) // 2 - 65
        if i10 not in sglut13:
            sglut13[i10] = int(1000.0 / (1.0 + math.exp(-x))) - 731
        x += 0.05
    sglut310 = {}
    x = 3.0
    while x <= 9.9 + 1e-9:
        i10 = fplog10(int(x * 1000 / 10)) // 10 - 14
        if i10 not in sglut310:
            sglut310[i10] = int(1000.0 / (1.0 + math.exp(-x))) - 952
        x += 0.1
    n13 = max(sglut13) + 1
    n310 = max(sglut310) + 1
    a = np.zeros(n13, dtype=np.int32)
    for k, v in sglut13.items():
        a[k] = v
    b = np.zeros(n310, dtype=np.int32)
    for k, v in sglut310.items():
        b[k] = v
    return a, b


SGLUT13, SGLUT310 = _build_sigmoid_luts()
# Paper: "24 values" and "6 elements"; construction reproduces those counts.
assert SGLUT13.shape[0] == 24, SGLUT13.shape
assert SGLUT310.shape[0] == 6, SGLUT310.shape


def fpsigmoid(x: int) -> int:
    """Alg. 2 fpsigmoid: x/y scale 1:1000; |error| < 1% (Fig. 11)."""
    x = int(x)
    mirror = x < 0
    if mirror:
        x = -x
    if x >= 10000:
        return 0 if mirror else 1000
    if x <= 1000:
        y = 500 + (x * 231) // 1000
        return 1000 - y if mirror else y
    elif x < 3000:
        i10 = fplog10(x // 5) // 2 - 65
        y = int(SGLUT13[i10]) + 731
        return 1000 - y if mirror else y
    else:
        i10 = fplog10(x // 10) // 10 - 14
        y = int(SGLUT310[i10]) + 952
        return 1000 - y if mirror else y


# ---------------------------------------------------------------------------
# Remaining fixed-point scalars (paper Tab. 4; implementations not given in
# the paper — quarter-wave LUT sine and Newton integer sqrt chosen).
# ---------------------------------------------------------------------------

# Quarter-wave sine LUT: 256 entries over [0, pi/2), y scale 1000.
_SIN_QUARTER = np.array(
    [int(round(math.sin(i * (math.pi / 2) / 256) * 1000)) for i in range(256)],
    dtype=np.int32,
)
_TWO_PI_MR = 6283  # 2*pi in milliradians


def fpsin(x: int) -> int:
    """Fixed-point sine: x in milliradians, y scale 1:1000."""
    x = int(x) % _TWO_PI_MR
    if x < 0:
        x += _TWO_PI_MR
    t = x * 1024 // _TWO_PI_MR  # 1024 steps per cycle
    quad, idx = divmod(t, 256)
    if quad == 0:
        return int(_SIN_QUARTER[idx])
    if quad == 1:
        return int(_SIN_QUARTER[255 - idx])
    if quad == 2:
        return -int(_SIN_QUARTER[idx])
    return -int(_SIN_QUARTER[255 - idx])


def fpsqrt(x: int) -> int:
    """Integer sqrt (floor)."""
    x = int(x)
    if x <= 0:
        return 0
    r = x
    y = (r + 1) // 2
    while y < r:
        r = y
        y = (r + x // r) // 2
    return r


def fprelu(x: int) -> int:
    return x if x > 0 else 0


# ---------------------------------------------------------------------------
# Beyond-paper improved sigmoid (see EXPERIMENTS.md "LUT accuracy"):
# the faithful Alg. 2/3 reproduction measures 2.2 % worst-case error (the
# paper claims <1 %; its 6-entry segment over [3,10) cannot achieve that).
# A 33-entry uniform LUT over [0,8] with linear interpolation reaches <0.2 %
# at comparable storage (66 B) and fewer unit ops than the log10-indexed
# scheme — this variant backs the lutact TPU kernel.
# ---------------------------------------------------------------------------

_SIG_INTERP_N = 32
_SIG_INTERP_MAX = 8000  # x scale 1:1000
_SIG_INTERP_LUT = np.array(
    [
        int(round(1000.0 / (1.0 + math.exp(-(i * _SIG_INTERP_MAX / _SIG_INTERP_N) / 1000.0))))
        for i in range(_SIG_INTERP_N + 1)
    ],
    dtype=np.int32,
)


def fpsigmoid_interp(x: int) -> int:
    """Improved fixed-point sigmoid: uniform LUT + linear interpolation."""
    x = int(x)
    mirror = x < 0
    if mirror:
        x = -x
    if x >= _SIG_INTERP_MAX:
        return 0 if mirror else 1000
    step = _SIG_INTERP_MAX // _SIG_INTERP_N
    i, r = divmod(x, step)
    y0 = int(_SIG_INTERP_LUT[i])
    y1 = int(_SIG_INTERP_LUT[i + 1])
    y = y0 + ((y1 - y0) * r) // step
    return 1000 - y if mirror else y


# ---------------------------------------------------------------------------
# Vectorized torch versions (used by the batched interpreter).  All are
# branch-free translations of the scalar code over int32 tensors; int32
# arithmetic wraps exactly as the reference's jnp forms do.
# ---------------------------------------------------------------------------

_LUTS: dict = {}


def lut(name: str, device) -> torch.Tensor:
    """One of the module's int32 LUTs as a tensor on ``device`` (cached)."""
    key = (name, str(device))
    if key not in _LUTS:
        arr = {
            "log10": LOG10_LUT,
            "sg13": SGLUT13,
            "sg310": SGLUT310,
            "sinq": _SIN_QUARTER,
            "sig_interp": _SIG_INTERP_LUT,
        }[name]
        _LUTS[key] = torch.as_tensor(np.asarray(arr, np.int32), device=device)
    return _LUTS[key]


def _fdiv(x: torch.Tensor, d) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def fplog10_t(x: torch.Tensor) -> torch.Tensor:
    """Branch-free fplog10.  Domain of interest: x in [10, 99999]."""
    x = torch.clamp(x.to(torch.int32), min=10)
    shift = torch.zeros_like(x)
    for _ in range(3):
        big = x >= 100
        shift = shift + big.to(torch.int32)
        x = torch.where(big, _fdiv(x, 10), x)
    tab = lut("log10", x.device)
    return shift * 100 + tab[torch.clamp(x - 10, 0, 89).long()]


def fpsigmoid_t(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int32)
    mirror = x < 0
    ax = torch.abs(x)
    y1 = 500 + _fdiv(ax * 231, 1000)
    i13 = torch.clamp(_fdiv(fplog10_t(_fdiv(ax, 5)), 2) - 65, 0, 23)
    y2 = lut("sg13", x.device)[i13.long()] + 731
    i310 = torch.clamp(_fdiv(fplog10_t(_fdiv(ax, 10)), 10) - 14, 0, 5)
    y3 = lut("sg310", x.device)[i310.long()] + 952
    y = torch.where(ax <= 1000, y1, torch.where(ax < 3000, y2, y3))
    y = torch.where(ax >= 10000, 1000, y)
    return torch.where(mirror, 1000 - y, y)


def fpsin_t(x: torch.Tensor) -> torch.Tensor:
    x = torch.remainder(x.to(torch.int32), _TWO_PI_MR)
    x = torch.where(x < 0, x + _TWO_PI_MR, x)
    t = _fdiv(x * 1024, _TWO_PI_MR)
    quad = _fdiv(t, 256)
    idx = torch.remainder(t, 256)
    tab = lut("sinq", x.device)
    up = tab[idx.long()]
    down = tab[(255 - idx).long()]
    mag = torch.where(torch.remainder(quad, 2) == 0, up, down)
    return torch.where(quad >= 2, -mag, mag)


def fpsqrt_t(x: torch.Tensor) -> torch.Tensor:
    """Integer sqrt via f32 sqrt + integer off-by-one correction (the
    reference's ``fpsqrt_jnp``; exact floor sqrt over the int32 range)."""
    x = torch.clamp(x.to(torch.int32), min=0)
    r = torch.sqrt(x.to(torch.float32)).to(torch.int32)
    r = torch.clamp(r, 1, 46340)
    r = torch.where(_fdiv(x, r + 1) >= (r + 1), r + 1, r)
    r = torch.where(_fdiv(x, r) < r, r - 1, r)
    return torch.where(x == 0, 0, torch.clamp(r, min=0))


def fpsigmoid_interp_t(x: torch.Tensor) -> torch.Tensor:
    """The interpolated sigmoid over int32 tensors (the reference's
    ``fpsigmoid_interp_jnp``; the plain version of the lut_sigmoid kernel).
    Not the Alg. 2 ``fpsigmoid_t`` of the VM's ``sigmoid`` word.  At
    INT_MIN ``abs`` wraps, the bucket clips to 0 and the product wraps, as
    in the reference."""
    x = x.to(torch.int32)
    mirror = x < 0
    ax = torch.abs(x)
    step = _SIG_INTERP_MAX // _SIG_INTERP_N
    i = torch.clamp(_fdiv(ax, step), 0, _SIG_INTERP_N - 1)
    r = ax - i * step
    tab = lut("sig_interp", x.device)
    y0 = tab[i.long()]
    y1 = tab[(i + 1).long()]
    y = y0 + _fdiv((y1 - y0) * r, step)
    y = torch.where(ax >= _SIG_INTERP_MAX, 1000, y)
    return torch.where(mirror, 1000 - y, y)
