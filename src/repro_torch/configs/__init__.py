"""The architecture registry (counterpart of ``repro/configs``):
``get_config(name, reduced=...)`` and ``list_archs()`` over the ten
architecture modules of this package, and the four input shapes
(``SHAPES``) with their inputs on the meta device (``input_specs``)."""
from repro_torch.configs.base import (SHAPES, InputShape, ModelConfig,  # noqa
                                      get_config, list_archs)
from repro_torch.configs.shapes import (cache_specs, dummy_inputs,  # noqa
                                        input_specs)

# Static imports of every registered architecture module, so a broken
# config module fails at import (base._ensure_loaded also loads them).
from repro_torch.configs import (deepseek_v3_671b, granite_3_2b,  # noqa
                                 internvl2_26b, mistral_nemo_12b,
                                 mixtral_8x7b, nemotron_4_15b, qwen1_5_0_5b,
                                 rwkv6_7b, whisper_base, zamba2_1_2b)
