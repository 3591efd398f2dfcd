"""Model family of the port: Llama-style decoders as torch modules."""
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.models.transformer import init_params

__all__ = ['ModelConfig', 'Transformer', 'init_params']
