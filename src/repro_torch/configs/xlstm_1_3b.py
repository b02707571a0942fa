"""Selectable config ``--arch xlstm-1-3b`` (see registry for the citation).

A copy of ``repro.configs.xlstm_1_3b`` (the port never imports the JAX
package)."""
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import XLSTM_1_3B as CONFIG

SMOKE = reduced(CONFIG)
