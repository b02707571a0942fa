"""Selectable config ``--arch whisper-medium`` (see registry for the citation).

A copy of ``repro.configs.whisper_medium`` (the port never imports the JAX
package)."""
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import WHISPER_MEDIUM as CONFIG

SMOKE = reduced(CONFIG)
