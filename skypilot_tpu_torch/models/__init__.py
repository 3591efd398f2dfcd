"""Model family of the port: Llama-style decoders as torch modules, their
losses and the single-GPU training step."""
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.losses import fused_linear_cross_entropy
from skypilot_tpu_torch.models.losses import streaming_cross_entropy
from skypilot_tpu_torch.models.train import TrainConfig
from skypilot_tpu_torch.models.train import create_train_state
from skypilot_tpu_torch.models.train import train_step
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.models.transformer import init_params

__all__ = ['ModelConfig', 'TrainConfig', 'Transformer',
           'create_train_state', 'fused_linear_cross_entropy',
           'init_params', 'streaming_cross_entropy', 'train_step']
