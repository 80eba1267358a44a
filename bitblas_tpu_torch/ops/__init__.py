"""Operators: MatmulConfig, the plain reference, weight transforms, the
Matmul operator and the FlashAtten operator (`FlashAtten`,
`FlashAttenConfig` exported here, as the JAX package exports them; loaded
on first use, since the kernels import ops.reference while this package
initializes)."""


def __getattr__(name):
    if name in ("FlashAtten", "FlashAttenConfig"):
        from . import flashatten
        return getattr(flashatten, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
