"""Models: the quantized Llama decoder, the Mixtral MoE decoder and
their unquantized LM ends."""

from .quant_llama import (  # noqa: F401
    DecoderServingMixin,
    LlamaConfig,
    QuantLlama,
    QuantLlamaLayer,
)
from .hf_import import (  # noqa: F401
    LMHead,
    QuantLlamaLM,
    llama_config_from_hf,
    load_quant_llama_from_hf_gptq,
    perplexity,
)
from .quant_moe import (  # noqa: F401
    MixtralConfig,
    MoEConfig,
    QuantMixtral,
    QuantMixtralLayer,
    QuantMoELayer,
)
from .hf_import_mixtral import (  # noqa: F401
    load_quant_mixtral_from_hf_gptq,
    mixtral_config_from_hf,
)
