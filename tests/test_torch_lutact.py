"""The port's lut_sigmoid (the interpolated fixed-point sigmoid) against
the JAX package: the public op ``fixed_sigmoid`` on the CPU (the kernel's
plain version) against the Pallas ``lut_sigmoid`` in interpret mode, the
reference's ``fixed_sigmoid`` and ``fpsigmoid_interp_jnp``; the kernel's
per-element body (``csrc/lutact_core.h``) built with g++ against the same.
Every comparison is exact, over a sweep with INT_MIN and INT_MAX.
"""

import ctypes
import hashlib
import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fixedpoint.luts import fpsigmoid_interp_jnp
from repro.kernels import set_kernels
from repro.kernels.lutact.lutact import lut_sigmoid as jlut_sigmoid
from repro.kernels.lutact.ops import fixed_sigmoid as jfixed_sigmoid

from repro_torch.core.fixedpoint import fpsigmoid_interp, fpsigmoid_interp_t
from repro_torch.core.fixedpoint.luts import lut
from repro_torch.kernels.lutact import fixed_sigmoid, lut_sigmoid, lut_sigmoid_ref

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "lutact" / "csrc"
I32 = np.iinfo(np.int32)


def sweep() -> np.ndarray:
    """INT_MIN, INT_MAX, the saturation edge, every multiple of 250 in
    +-8250 with its neighbours, then 2**16 random int32."""
    edges = [I32.min, I32.min + 1, I32.max, I32.max - 1, 0, 1, -1]
    edges += [s * x for s in (1, -1) for x in (7999, 8000, 8001)]
    edges += [m + d for m in range(-8250, 8251, 250) for d in (-1, 0, 1)]
    rnd = np.random.default_rng(0).integers(I32.min, I32.max, 2 ** 16, dtype=np.int64, endpoint=True)
    return np.concatenate([np.array(edges, np.int64), rnd]).astype(np.int32)


X = sweep()


def _port(x: np.ndarray) -> np.ndarray:
    return fixed_sigmoid(torch.tensor(x)).numpy()


def test_sweep_matches_jnp_reference():
    assert np.array_equal(_port(X), np.asarray(fpsigmoid_interp_jnp(jnp.array(X))))


def test_sweep_matches_pallas_kernel_in_interpret_mode():
    pad = np.zeros(512 * 256, np.int32)
    pad[: X.size] = X[: pad.size]
    x2 = pad.reshape(512, 256)
    ref = np.asarray(jlut_sigmoid(jnp.array(x2), interpret=True))
    assert np.array_equal(_port(x2), ref)


@pytest.mark.parametrize("shape", [(5,), (3, 50), (2, 3, 33), (1, 257), (7, 1, 300)])
def test_any_shape_matches_reference_op(shape):
    """The reference op pads to 256-blocks; the port's takes any shape as
    it is."""
    x = np.random.default_rng(len(shape)).integers(-12000, 12000, shape).astype(np.int32)
    x.flat[0] = I32.min
    set_kernels("interpret")
    try:
        ref = np.asarray(jfixed_sigmoid(jnp.array(x)))
    finally:
        set_kernels("auto")
    out = _port(x)
    assert out.shape == shape and out.dtype == np.int32 and np.array_equal(out, ref)


def test_tensor_form_matches_scalar_form():
    """Equal to the scalar ``fpsigmoid_interp`` everywhere but INT_MIN,
    where the reference's tensor form wraps (|INT_MIN| < 0, bucket 0,
    a wrapped product: 500) and the scalar one, on Python ints, saturates
    to 0: a known difference inside the reference itself."""
    out = fpsigmoid_interp_t(torch.tensor(X)).tolist()
    for x, y in zip(X.tolist(), out):
        assert y == (500 if x == I32.min else fpsigmoid_interp(x)), x
    assert int(jnp.asarray(fpsigmoid_interp_jnp(jnp.array([I32.min], jnp.int32)))[0]) == 500


def test_cpu_wrapper_takes_the_plain_version():
    launches = lut_sigmoid.launches
    x = torch.tensor(X)
    assert torch.equal(lut_sigmoid(x), lut_sigmoid_ref(x))
    assert lut_sigmoid.launches == launches
    with pytest.raises(ValueError, match="int32"):
        lut_sigmoid(x.to(torch.int64))
    assert fixed_sigmoid(torch.zeros(0, dtype=torch.int32)).shape == (0,)


def test_meets_paper_accuracy_target():
    xs = np.arange(-12000, 12001, 11).astype(np.int32)
    out = _port(xs) / 1000.0
    assert np.abs(out - 1.0 / (1.0 + np.exp(-xs / 1000.0))).max() < 0.01


@pytest.fixture(scope="module")
def host_lib():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's per-element body for the CPU")
    src = CSRC / "lutact_host.cpp"
    digest = hashlib.sha256(src.read_bytes() + (CSRC / "lutact_core.h").read_bytes()).hexdigest()[:16]
    out = ROOT / "build" / "repro_torch_test" / f"liblutact_host_{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{digest}.tmp")
        subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
                        "-o", str(tmp), str(src)], check=True, capture_output=True, text=True)
        tmp.replace(out)
    fn = ctypes.CDLL(str(out)).lut_sigmoid_host
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
    fn.restype = ctypes.c_int
    return fn


def test_kernel_body_built_with_gxx_matches_reference(host_lib):
    x = torch.tensor(X)
    out = torch.empty_like(x)
    tab = lut("sig_interp", "cpu")
    assert host_lib(x.data_ptr(), out.data_ptr(), tab.data_ptr(), x.numel()) == 0
    assert torch.equal(out, lut_sigmoid_ref(x))
    assert np.array_equal(out.numpy(), np.asarray(fpsigmoid_interp_jnp(jnp.array(X))))
