"""Selectable config ``--arch grok-1-314b`` (see registry for the citation).

A copy of ``repro.configs.grok_1_314b`` (the port never imports the JAX
package)."""
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import GROK_1_314B as CONFIG

SMOKE = reduced(CONFIG)
