"""Step telemetry of the training loop (the counterpart of
`skypilot_tpu/callbacks/`): `init()` once, `step()` around each step;
`summary.json` lands in SKYTPU_BENCHMARK_LOG_DIR.  The framework
integrations (transformers, lightning, keras) are not ported yet."""
from skypilot_tpu_torch.callbacks.base import SkyTpuCallback
from skypilot_tpu_torch.callbacks.base import init
from skypilot_tpu_torch.callbacks.base import on_step_begin
from skypilot_tpu_torch.callbacks.base import on_step_end
from skypilot_tpu_torch.callbacks.base import step

__all__ = ['SkyTpuCallback', 'init', 'on_step_begin', 'on_step_end',
           'step']
