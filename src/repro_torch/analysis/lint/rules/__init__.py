"""scarlint rule plugins for the port.

Importing this package registers the built-in rules (SL001-SL005) with the
registry in ``base``; external rules register the same way — subclass
``Rule`` and decorate with ``@register`` before calling the runner.
"""
from __future__ import annotations

from .base import (MemoSig, ProjectIndex, Rule, default_rules,  # noqa: F401
                   register, rule_catalog)
from . import jit_statics      # noqa: F401  (registers SL005)
from . import quantized_ties   # noqa: F401  (registers SL004)
from . import seeded_rng       # noqa: F401  (registers SL003)
from . import sync_discipline  # noqa: F401  (registers SL002)
from . import xp_generic       # noqa: F401  (registers SL001)

__all__ = ["MemoSig", "ProjectIndex", "Rule", "default_rules", "register",
           "rule_catalog"]
