"""Model configurations (flagship: Llama-3-8B).

Mirrors `skypilot_tpu/models/configs.py` field for field and preset for
preset, with torch dtypes in place of jnp ones.  `to_json_dict` /
`config_from_json_dict` write and read the same `model_config.json`
shape as the reference (dtypes as their numpy names).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPE_NAMES = {torch.float32: 'float32', torch.bfloat16: 'bfloat16',
                torch.float16: 'float16'}
_NAME_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    # RoPE frequency scaling: None, 'linear' or 'llama3' (Llama-3.1).
    rope_scaling_type: Optional[str] = None
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_len: int = 8192
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16      # activations/compute
    param_dtype: torch.dtype = torch.float32
    # Training-side switches kept for config round trips; the serving
    # path ignores them.
    remat: bool = True
    remat_policy: str = 'full'
    # Reference param-tree layout: stacked [L, ...] under
    # params['layers']['layer'] when True, params['layer_{i}'] when
    # False (models/convert.py reads both).
    scan_layers: bool = True
    # lm_head matmul in f32 (True) or the activation dtype; logits are
    # returned in f32 either way.
    logits_in_f32: bool = True
    sequence_parallel: str = 'ring'
    # Mixture-of-Experts (0 experts = dense MLP).
    n_experts: int = 0
    expert_top_k: int = 2
    expert_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.02
    # Family switches beyond Llama (Gemma/Qwen-style decoders):
    tie_embeddings: bool = False      # lm_head = embed^T (Gemma)
    qkv_bias: bool = False            # bias on q/k/v projections (Qwen2)
    mlp_act: str = 'silu'             # 'silu' (Llama) | 'gelu' (Gemma)
    norm_scale_plus_one: bool = False  # RMSNorm x (1 + w) (Gemma)
    scale_embeddings: bool = False    # embed x sqrt(d_model) (Gemma)
    head_dim_override: Optional[int] = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.d_model // self.n_heads

    def replace(self, **kw) -> 'ModelConfig':
        return dataclasses.replace(self, **kw)

    def to_json_dict(self) -> dict:
        """JSON-serializable form (dtypes as their numpy names); inverse
        of config_from_json_dict."""
        d = dataclasses.asdict(self)
        d['dtype'] = _DTYPE_NAMES[self.dtype]
        d['param_dtype'] = _DTYPE_NAMES[self.param_dtype]
        return d


def config_from_json_dict(d: dict) -> ModelConfig:
    d = dict(d)
    for key in ('dtype', 'param_dtype'):
        if isinstance(d.get(key), str):
            if d[key] not in _NAME_DTYPES:
                raise ValueError(f'Unknown {key} {d[key]!r}; have '
                                 f'{sorted(_NAME_DTYPES)}')
            d[key] = _NAME_DTYPES[d[key]]
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f'Unknown ModelConfig fields {sorted(unknown)}')
    return ModelConfig(**d)


LLAMA3_8B = ModelConfig()
LLAMA3_70B = ModelConfig(d_model=8192, n_layers=80, n_heads=64,
                         n_kv_heads=8, d_ff=28672)
SMALL = ModelConfig(vocab_size=32000, d_model=1024, n_layers=8, n_heads=16,
                    n_kv_heads=8, d_ff=4096, max_seq_len=2048)
TINY = ModelConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=128, max_seq_len=128,
                   dtype=torch.float32, remat=False)
MIXTRAL_8X7B = ModelConfig(vocab_size=32000, d_model=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, d_ff=14336,
                           rope_theta=1e6, n_experts=8, expert_top_k=2)
TINY_MOE = TINY.replace(n_experts=4, expert_top_k=2)
GEMMA_2B = ModelConfig(vocab_size=256000, d_model=2048, n_layers=18,
                       n_heads=8, n_kv_heads=1, d_ff=16384,
                       rope_theta=10000.0, tie_embeddings=True,
                       mlp_act='gelu', norm_scale_plus_one=True,
                       scale_embeddings=True)
QWEN2_7B = ModelConfig(vocab_size=152064, d_model=3584, n_layers=28,
                       n_heads=28, n_kv_heads=4, d_ff=18944,
                       rope_theta=1e6, qkv_bias=True)
TINY_GEMMA = TINY.replace(tie_embeddings=True, mlp_act='gelu',
                          norm_scale_plus_one=True, scale_embeddings=True,
                          n_kv_heads=1)
TINY_QWEN = TINY.replace(qkv_bias=True)

PRESETS = {
    'llama3-8b': LLAMA3_8B,
    'llama3-70b': LLAMA3_70B,
    'mixtral-8x7b': MIXTRAL_8X7B,
    'gemma-2b': GEMMA_2B,
    'qwen2-7b': QWEN2_7B,
    'small': SMALL,
    'tiny': TINY,
    'tiny-moe': TINY_MOE,
    'tiny-gemma': TINY_GEMMA,
    'tiny-qwen': TINY_QWEN,
}


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in PRESETS:
        raise ValueError(f'Unknown model preset {name!r}; '
                         f'have {sorted(PRESETS)}')
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg
