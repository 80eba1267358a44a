"""Shared by the port's tests that hold a configuration to the JAX
package: reference-layout operands for any configuration (JAX's
random_reference_operands makes only some activation types), JAX's
oracle on them, the port's Matmul on them, the comparison, and the class
JAX raises for a configuration it refuses."""

import numpy as np
import torch

import jax.numpy as jnp

from bitblas_tpu.ops.matmul import Matmul as JaxMatmul
from bitblas_tpu.ops.matmul_config import MatmulConfig as JaxMatmulConfig
from bitblas_tpu.ops.reference import matmul_reference
from bitblas_tpu.ops.weight_transform import \
    transform_reference_operands as jax_transform

from bitblas_tpu_torch.ops import weight_transform as wt
from bitblas_tpu_torch.ops.matmul import Matmul
from bitblas_tpu_torch.quantization.formats import TORCH_DTYPES

FLOAT8 = {"e4m3_float8": torch.float8_e4m3fn, "e5m2_float8": torch.float8_e5m2}


def to_torch(a):
    """A numpy operand (ml_dtypes bfloat16 / float8 included) as the
    port's torch storage (uint16 / uint32 in the next wider signed type)."""
    a = np.asarray(a)
    name = str(a.dtype)
    if name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    if name in ("float8_e4m3fn", "float8_e5m2"):
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            FLOAT8["e4m3_float8" if "e4m3" in name else "e5m2_float8"])
    if a.dtype in (np.uint16, np.uint32):
        return torch.from_numpy(a.astype(np.int64 if a.dtype == np.uint32
                                         else np.int32))
    return torch.from_numpy(a.copy())


def port_forward(pc, A, qweight, scales=None, zeros=None, qzeros=None,
                 bias=None):
    """The port's Matmul (CPU) on reference-layout operands."""
    op = Matmul(pc, device="cpu", enable_tuning=False)
    if pc.is_native_compute():
        return op.forward(to_torch(A), op.transform_weight(to_torch(
            qweight)), bias=None if bias is None else to_torch(bias))
    dw = wt.transform_reference_operands(pc, np.asarray(qweight), scales,
                                         zeros, qzeros, bias)
    return op.forward(to_torch(A), dw.qweight, scale=dw.scales,
                      zeros=dw.zeros, bias=dw.bias)


def _np_dtype(name):
    import ml_dtypes
    return {"bfloat16": ml_dtypes.bfloat16,
            "e4m3_float8": ml_dtypes.float8_e4m3fn,
            "e5m2_float8": ml_dtypes.float8_e5m2,
            "int4": np.int8, "uint4": np.int8}.get(name) or np.dtype(name)


def operands(kw, seed=0):
    """Reference-layout operands of a configuration (JAX's
    random_reference_operands takes only some activation types): A and a
    native weight of small values, every code of a quantized weight (wide
    ones within 1024), scales, zeros or quantized zeros, a bias."""
    from bitblas_tpu.quantization import packing as jpack
    rng = np.random.default_rng(seed)
    m, n, k = kw["M"], kw["N"], kw["K"]
    g = k if kw.get("group_size", -1) == -1 else kw["group_size"]

    def dense(shape, name):
        if name not in TORCH_DTYPES:   # packed: JAX's oracle refuses it
            name = "float16"
        if name.startswith(("int", "uint")):
            lo, hi = (0, 16) if name.startswith("u") else (-8, 8)
            return rng.integers(lo, hi, shape).astype(_np_dtype(name))
        return rng.standard_normal(shape).astype(_np_dtype(name))

    a, w = kw["A_dtype"], kw["W_dtype"]
    A = dense((m, k), a)
    jc = JaxMatmulConfig(**{f: v for f, v in kw.items() if v is not None})
    out = dict(A=A, scales=None, zeros=None, qzeros=None,
               bias=rng.standard_normal(n).astype(np.float32)
               if kw.get("with_bias") else None)
    if jc.is_native_compute():
        return dict(out, qweight=dense((n, k), w))
    bits, fam = jc.bit, jc.source_format
    if bits < 8:
        q = jpack.general_compress(rng.integers(0, 1 << bits, (n, k))
                                   .astype(np.uint8), bits)
    elif bits > 8:
        q = rng.integers(-1024 if fam == "int" else 0, 1024, (n, k)).astype(
            f"{'u' if fam == 'uint' else ''}int{bits}")
    else:
        q = rng.integers(0, 256, (n, k)).astype(np.uint8).view(np.int8)
    out["qweight"] = q
    if kw.get("with_scaling"):
        out["scales"] = (rng.random((n, k // g)) * 0.5 + 0.05).astype(
            np.float16)
    if kw.get("with_zeros"):
        if kw.get("zeros_mode") == "quantized":
            z = rng.integers(0, 1 << min(bits, 8), (k // g, n)).astype(
                np.uint8)
            out["qzeros"] = jpack.general_compress(z, bits) if bits < 8 \
                else z.view(np.int8)
        else:
            out["zeros"] = rng.integers(0, 8, (n, k // g)).astype(np.float16)
    return out


def oracle(kw, ops):
    """JAX's result on the operands, as float64 numpy: its oracle
    (matmul_reference) for a quantized configuration, its Matmul (the XLA
    dot, then astype and the bias in the output type) for a native one."""
    j = (lambda x: None if x is None else jnp.asarray(x))
    jc = JaxMatmulConfig(**kw)
    if jc.is_native_compute():
        jop = JaxMatmul(jc, enable_tuning=False)
        W, b = ops["qweight"], ops["bias"]
        want = jop.forward(j(ops["A"]), j(W), bias=j(b))
    else:
        want = matmul_reference(jc, j(ops["A"]), j(ops["qweight"]),
                                j(ops["scales"]), j(ops["zeros"]),
                                j(ops["qzeros"]), j(ops["bias"]))
    want = np.asarray(want)
    return want.astype(np.float64) if want.dtype.kind in "iu" \
        else want.astype(np.float32).astype(np.float64)


def as_f64(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype in FLOAT8.values() else t).double().numpy()


def agrees(got: np.ndarray, want: np.ndarray, rtol: float = 1e-3) -> bool:
    """NaN and inf where JAX has them, else within rtol of the largest
    finite output (the port decodes JAX's weight bit for bit; float32
    sums in another order, float64 where JAX, without x64, has float32)."""
    if not (np.array_equal(np.isnan(got), np.isnan(want))
            and np.array_equal(np.isposinf(got), np.isposinf(want))
            and np.array_equal(np.isneginf(got), np.isneginf(want))):
        return False
    fin = np.isfinite(want)
    top = np.max(np.abs(want[fin]), initial=0.0)
    return bool(np.all(np.abs(got[fin] - want[fin]) <= rtol * top + 1e-6))


def jax_refusal(kw):
    """The class JAX raises for a configuration (its config, its Matmul's
    build, its oracle on operands), or None."""
    try:
        jc = JaxMatmulConfig(**kw)
        JaxMatmul(jc, enable_tuning=False)
        ops = operands(kw)
        if not jc.is_native_compute():
            jax_transform(jc, ops["qweight"], ops["scales"], ops["zeros"],
                          ops["qzeros"])
        oracle(kw, ops)
    except Exception as e:   # noqa: BLE001 - the class is the result
        return type(e)
    return None
