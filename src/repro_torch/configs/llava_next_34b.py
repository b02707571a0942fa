"""Selectable config ``--arch llava-next-34b`` (see registry for the citation).

A copy of ``repro.configs.llava_next_34b`` (the port never imports the JAX
package)."""
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import LLAVA_NEXT_34B as CONFIG

SMOKE = reduced(CONFIG)
