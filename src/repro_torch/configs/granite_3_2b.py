"""Selectable config ``--arch granite-3-2b`` (see registry for the citation).

A copy of ``repro.configs.granite_3_2b`` (the port never imports the JAX
package)."""
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import GRANITE_3_2B as CONFIG

SMOKE = reduced(CONFIG)
