"""Selectable config ``--arch qwen3-moe-30b`` (see registry for the citation).

A copy of ``repro.configs.qwen3_moe_30b_a3b`` (the port never imports the JAX
package)."""
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import QWEN3_MOE_30B as CONFIG

SMOKE = reduced(CONFIG)
