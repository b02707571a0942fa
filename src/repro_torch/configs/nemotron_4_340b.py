"""Selectable config ``--arch nemotron-4-340b`` (see registry for the citation).

A copy of ``repro.configs.nemotron_4_340b`` (the port never imports the JAX
package)."""
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import NEMOTRON_4_340B as CONFIG

SMOKE = reduced(CONFIG)
