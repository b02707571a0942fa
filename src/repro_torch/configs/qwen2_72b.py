"""Selectable config ``--arch qwen2-72b`` (see registry for the citation).

A copy of ``repro.configs.qwen2_72b`` (the port never imports the JAX
package)."""
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import QWEN2_72B as CONFIG

SMOKE = reduced(CONFIG)
