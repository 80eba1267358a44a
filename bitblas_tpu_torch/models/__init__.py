"""Models: BitNet b1.58 layers, the quantized Llama decoder, the Mixtral
MoE decoder, their unquantized LM ends, the float-checkpoint quantizers
and speculative decoding."""

from .bitnet import (  # noqa: F401
    BitLinearInference,
    BitNetLlama,
    BitNetLlamaLayer,
    activation_quant,
    activation_quant_int8,
    bitlinear_train_forward,
    ste,
    weight_quant,
    weight_quant_codes,
)
from .quant_llama import (  # noqa: F401
    DecoderServingMixin,
    LlamaConfig,
    QuantLlama,
    QuantLlamaLayer,
    layer_forward,
    rmsnorm,
    rope,
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
from .quantize_hf import (  # noqa: F401
    quantize_llama_from_hf_fp16,
    quantize_mixtral_from_hf_fp16,
)
from .speculative import (  # noqa: F401
    SpecStats,
    speculative_generate,
    speculative_generate_cached,
)
