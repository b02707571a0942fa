"""Selectable config ``--arch zamba2-7b`` (see registry for the citation).

A copy of ``repro.configs.zamba2_7b`` (the port never imports the JAX
package)."""
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ZAMBA2_7B as CONFIG

SMOKE = reduced(CONFIG)
