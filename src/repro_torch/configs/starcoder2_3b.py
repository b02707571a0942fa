"""Selectable config ``--arch starcoder2-3b`` (see registry for the citation).

A copy of ``repro.configs.starcoder2_3b`` (the port never imports the JAX
package)."""
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import STARCODER2_3B as CONFIG

SMOKE = reduced(CONFIG)
