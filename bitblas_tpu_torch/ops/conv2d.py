"""Conv2D and QuantConv2D (counterpart of bitblas_tpu/ops/conv2d.py).

JAX's API: x NHWC, the filter HWIO, the output NHWC; stride S, dilation D
and padding P on both spatial axes, a square K x K filter.

* `Conv2D`: JAX's `lax.conv_general_dilated` with no Pallas kernel, so a
  library convolution is its counterpart: `F.conv2d` on NCHW / OIHW
  views of the NHWC / HWIO tensors (channels_last memory, no copy of x),
  float sums in float32, cast to out_dtype (float16 / bfloat16 in and out
  in one cuDNN call; another output type from the float32 convolution of
  float32 copies, TF32 off). PyTorch has no integer convolution, so int8
  takes the exact route of QuantConv2D's int8 plan: im2col patches and
  int32 sums (`torch._int_mm`).
* `QuantConv2D`: a weight-quantized filter over the contraction C*KH*KW,
  packed by `transform_weight` exactly as `Matmul` packs [F, C*KH*KW]
  codes (flattened channel-major, (C, KH, KW), JAX's patch order).
  `route` picks the plan, decided as JAX decides it (`resolve_route`):
  - "materialize": the filter decoded to a dense [F, C*KH*KW] operand
    once (kernels/materialize.decode_weight: kernel 2 to A's type for
    float activations, kernel 3 to int8 codes for int8 ones), then the
    library convolution on it (float), or, for int8 activations, the
    exact integer convolution as patches times codes in int32 sums with
    the per-channel post-scale in float32;
  - "fused": im2col patches [N*Ho*Wo, C*KH*KW] into kernel 1 through the
    Matmul operator (the decode stays in registers). M = N*Ho*Wo runs
    past every Matmul bucket, where the untuned routing would take the
    materialize plan from M = 512: the route pins kernel 1's default tile
    for its M (with `enable_tuning`, the fastest measured fused tile);
  - "auto": materialize where the filter decodes to a dense operand at
    all (`supports_materialize_spec`), else fused. Grouped scales with
    int8 activations stay fused; forcing materialize there raises
    ValueError.
  A bias is added in float32 before the cast on both routes (JAX's fused
  route drops it: its Matmul is built without `with_bias`). `decode_impl`
  ("pallas" / "xla", a choice between two TPU decoders) is accepted and
  changes nothing: on the card the materialize route decodes with the
  hand-written kernel.

Patches come from `Tensor.unfold` views of the padded input, which take
every dtype (`F.unfold` refuses int8), already in (C, KH, KW) order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from ..common import resolve_device
from ..kernels.dense import dense_product, full_f32
from ..kernels.dequant_matmul import default_tile, spec_format
from ..kernels.materialize import decode_weight, supports_materialize_spec
from ..kernels.spec import KernelSpec
from ..quantization import numerics
from ..quantization.formats import as_torch_dtype
from ..tuner.hint import TileHint
from .matmul import Matmul
from .matmul_config import MatmulConfig, OperatorConfig
from .weight_transform import as_tensor


@dataclass(frozen=True)
class Conv2DConfig(OperatorConfig):
    N: Optional[int] = None          # batch
    C: Optional[int] = None          # in channels
    H: Optional[int] = None
    W: Optional[int] = None
    F: Optional[int] = None          # out channels
    K: Optional[int] = None          # kernel size (square)
    S: int = 1                       # stride
    D: int = 1                       # dilation
    P: int = 0                       # padding
    in_dtype: str = "float16"
    out_dtype: str = "float16"
    accum_dtype: str = "float32"

    def __post_init__(self):
        for f in ("N", "C", "H", "W", "F", "K"):
            if getattr(self, f) is None:
                raise ValueError(f"{f} must be specified")

    @property
    def out_hw(self) -> Tuple[int, int]:
        span = self.D * (self.K - 1) + 1
        return ((self.H + 2 * self.P - span) // self.S + 1,
                (self.W + 2 * self.P - span) // self.S + 1)


def conv_patches(x: torch.Tensor, c: Conv2DConfig) -> torch.Tensor:
    """x [N, H, W, C] -> im2col patches [N*Ho*Wo, C*KH*KW], features
    channel-major (C, KH, KW) as JAX's conv_general_dilated_patches."""
    span = c.D * (c.K - 1) + 1
    xp = F.pad(x, (0, 0, c.P, c.P, c.P, c.P))
    p = xp.unfold(1, span, c.S).unfold(2, span, c.S)   # [N,Ho,Wo,C,s,s]
    p = p[..., ::c.D, ::c.D]
    n, ho, wo = p.shape[:3]
    return p.reshape(n * ho * wo, c.C * c.K * c.K)


def _check_input(x: torch.Tensor, c: Conv2DConfig, dtype) -> None:
    if x.dim() != 4 or tuple(x.shape[1:]) != (c.H, c.W, c.C) \
            or x.dtype != dtype:
        raise ValueError(f"x: expected {dtype} [N, {c.H}, {c.W}, {c.C}], "
                         f"got {x.dtype} {tuple(x.shape)}")


def conv2d_float(x: torch.Tensor, w_oihw: torch.Tensor, c: Conv2DConfig,
                 out_dtype: torch.dtype, bias=None) -> torch.Tensor:
    """The float convolution of NHWC x with an OIHW filter -> NHWC in
    out_dtype: float32 sums, a float32 bias added before the cast. On the
    card a 16-bit x and filter with a 16-bit output of their type run as
    one cuDNN convolution (float32 sums inside, one rounding; a bias then
    adds to that output); on the CPU, and for any other output type, the
    float32 convolution of float32 copies, TF32 off."""
    xc = x.permute(0, 3, 1, 2)                        # NCHW view
    kw = dict(stride=c.S, padding=c.P, dilation=c.D)
    if x.device.type == "cuda" and out_dtype == x.dtype \
            and x.dtype in (torch.float16, torch.bfloat16):
        w = w_oihw.to(x.dtype).contiguous(memory_format=torch.channels_last)
        out = F.conv2d(xc, w, **kw)
    else:
        with full_f32():
            out = F.conv2d(xc.float(), w_oihw.float(), **kw)
    if bias is not None:
        out = out.float() + bias.reshape(1, -1, 1, 1).float()
    return out.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def conv2d_int(x: torch.Tensor, codes_f_ckk: torch.Tensor,
               c: Conv2DConfig) -> torch.Tensor:
    """The exact integer convolution of int8 NHWC x with int8 filter rows
    [F, C*KH*KW] (channel-major): int32 sums [N, Ho, Wo, F]."""
    out = dense_product(conv_patches(x, c).contiguous(), codes_f_ckk,
                        torch.int32)
    ho, wo = c.out_hw
    return out.reshape(x.shape[0], ho, wo, -1)


class Conv2D:
    """NHWC x HWIO convolution through the library (cuDNN, or the exact
    integer route for int8)."""

    def __init__(self, config: Conv2DConfig, name: str = "conv2d",
                 target: Optional[str] = None, enable_tuning: bool = False,
                 device="cuda", **_):
        del target, enable_tuning
        self.name = name
        self.config = config
        self.device = resolve_device(device)
        self.dtype = as_torch_dtype(config.in_dtype)
        self.out_dtype = as_torch_dtype(config.out_dtype)

    def forward(self, x, w) -> torch.Tensor:
        """x [N, H, W, C], w [K, K, C, F] -> [N, H', W', F], on the
        operator's device."""
        c = self.config
        x, w = as_tensor(x, self.device), as_tensor(w, self.device)
        _check_input(x, c, self.dtype)
        if tuple(w.shape) != (c.K, c.K, c.C, c.F) or w.dtype != self.dtype:
            raise ValueError(f"w: expected {self.dtype} "
                             f"{(c.K, c.K, c.C, c.F)}, got {w.dtype} "
                             f"{tuple(w.shape)}")
        if x.is_floating_point():
            return conv2d_float(x, w.permute(3, 2, 0, 1), c, self.out_dtype)
        rows = w.permute(3, 2, 0, 1).reshape(c.F, -1).contiguous()
        return conv2d_int(x, rows, c).to(self.out_dtype)

    def __call__(self, *args: Any, **kw: Any) -> Any:
        return self.forward(*args, **kw)


@dataclass(frozen=True)
class QuantConv2DConfig(Conv2DConfig):
    """A weight-quantized convolution: any W_dtype the Matmul operator
    runs with in_dtype, scales grouped along the C*KH*KW contraction;
    `route` "auto", "materialize" or "fused" (module docstring);
    `decode_impl` accepted for JAX's configs and unused."""
    W_dtype: str = "uint4"
    group_size: int = -1
    with_scaling: bool = True
    with_zeros: bool = False
    zeros_mode: str = "original"
    route: str = "auto"
    decode_impl: str = "pallas"


def resolve_route(route: str, spec: KernelSpec, config) -> str:
    """JAX's `_resolve_route`: "auto" is materialize where the filter
    decodes to a dense operand (`supports_materialize_spec`), else fused;
    forcing materialize where it does not raises ValueError."""
    if route not in ("auto", "fused", "materialize"):
        raise ValueError(f"unknown route {route!r}")
    ok = supports_materialize_spec(spec)
    if route == "materialize" and not ok:
        raise ValueError(
            f"materialize route unsupported for W_dtype={config.W_dtype} "
            f"A_dtype={config.in_dtype} (native compute, or zeros / "
            f"grouped-scale limits on int activations)")
    if route == "auto":
        return "materialize" if ok else "fused"
    return route


class QuantConv2D:
    """forward(x [N, H, W, C], *packed), packed from `transform_weight`;
    the contraction K = C*KH*KW, the F filters the output columns."""

    def __init__(self, config: QuantConv2DConfig, name: str = "quant_conv2d",
                 target: Optional[str] = None, enable_tuning: bool = False,
                 device="cuda", **kw):
        del target
        self.name = name
        self.config = config
        c = config
        ho, wo = c.out_hw
        self.m = c.N * ho * wo
        mm_cfg = MatmulConfig(
            M=self.m, N=c.F, K=c.C * c.K * c.K, A_dtype=c.in_dtype,
            W_dtype=c.W_dtype, out_dtype=c.out_dtype,
            accum_dtype=c.accum_dtype, group_size=c.group_size,
            with_scaling=c.with_scaling, with_zeros=c.with_zeros,
            zeros_mode=c.zeros_mode, with_bias=True)
        self.spec = KernelSpec.from_config(mm_cfg, self.m)
        self.route = resolve_route(c.route, self.spec, c)
        # the Matmul packs the filter for both routes and runs the fused
        # one; it is tuned only where its kernels run
        fused = self.route == "fused"
        self.matmul = Matmul(mm_cfg, name=f"{name}_mm", device=device,
                             enable_tuning=enable_tuning and fused, **kw)
        self.device = self.matmul.device
        self.dtype = as_torch_dtype(c.in_dtype)
        self.out_dtype = as_torch_dtype(c.out_dtype)
        self._mm_fn = None
        if fused:
            self.matmul.apply_hints({self.m: self._fused_hint()},
                                    pin=self.m in self.matmul.tune_results)
            self._mm_fn = self.matmul.kernel_for(self.m)

    def _fused_hint(self) -> TileHint:
        """Kernel 1's tile at M = N*Ho*Wo: the fastest fused candidate the
        tuner measured, else the default tile."""
        result = self.matmul.tune_results.get(self.m)
        if result is not None:
            fused = [(t, h) for h, t, _ in result.candidates
                     if h.decode_mode == "fused"]
            if fused:
                return min(fused, key=lambda r: r[0])[1]
        return TileHint("fused", *default_tile(spec_format(self.spec),
                                               self.m))

    def transform_weight(self, weight, scale=None, zeros=None, bias=None):
        """weight [KH, KW, C, F] codes -> the Matmul's device operands
        ([F, C*KH*KW] packed, channel-major); scale / zeros [F, K/group]
        over that flattened contraction, bias [F]."""
        w = as_tensor(weight)
        kh, kw, cin, f = w.shape
        flat = w.permute(3, 2, 0, 1).reshape(f, cin * kh * kw)
        return self.matmul.transform_weight(flat, scale=scale, zeros=zeros,
                                             bias=bias)

    def forward(self, x, W, scale=None, zeros=None, bias=None):
        c = self.config
        x = as_tensor(x, self.device)
        if x.is_floating_point() and self.dtype.is_floating_point:
            x = x.to(self.dtype)
        _check_input(x, c, self.dtype)
        if (c.with_scaling and scale is None) or \
                (c.with_zeros and zeros is None):
            raise ValueError("this configuration needs scale and zeros")
        ho, wo = c.out_hw
        if self._mm_fn is not None:
            rest = [t for t, on in ((scale, c.with_scaling),
                                    (zeros, c.with_zeros)) if on]
            out = self._mm_fn(conv_patches(x, c).contiguous(), W, *rest,
                              bias)
            return out.reshape(x.shape[0], ho, wo, c.F)
        dense = decode_weight(self.spec, W, scale, zeros)   # [F, C*KH*KW]
        if self.spec.is_int_activation:
            out = conv2d_int(x, dense, c)
            if c.with_scaling:    # per channel: [1, F]
                out = out.float() * scale.reshape(-1).float()
            if bias is not None:
                out = out.float() + bias.reshape(-1).float()
            return numerics.saturate_cast(out, self.out_dtype)
        return conv2d_float(x, dense.reshape(c.F, c.C, c.K, c.K), c,
                            self.out_dtype, bias)

    def __call__(self, *args: Any, **kw: Any) -> Any:
        return self.forward(*args, **kw)
