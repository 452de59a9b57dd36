"""scarlint for the port — AST-based invariant linter of ``repro_torch``.

The counterpart of ``repro.analysis.lint``: the same rule ids, contracts,
suppressions, baseline mechanism and CLI, with rules that speak torch.
The port's cross-backend guarantees (one cost model priced identically by
the numpy oracle, the plain torch forms and the CUDA kernels; counted
host syncs; seeded RNG; quantised, stable tie-breaks; memoised-call
hygiene) are conventions differential tests only catch *after* a
violation ships.  scarlint machine-checks them at the source level:

* **SL001** xp-genericity — functions taking an ``xp`` namespace parameter
  may not call bare ``np.``/``torch.`` math;
* **SL002** sync discipline — ``core/``/``kernels/`` move data between
  host and device only through the counted ``launch.platform``
  helpers: no ``.item()``/``.cpu()``/``.tolist()``/``float()`` of a
  tensor, no ``torch.nonzero``/``torch.cuda.synchronize``, no
  ``torch.tensor(..., device=...)`` upload;
* **SL003** seeded RNG — no global-stream randomness (numpy, stdlib,
  torch's default generators) inside ``src/repro_torch/``;
* **SL004** quantised tie-breaks — score orderings round through
  ``core.quantize`` and torch sorts of them pass ``stable=True``; no
  ``torch.topk`` in ``core/``/``kernels/``/``models/``;
* **SL005** cache-key hazards — call sites of ``functools.lru_cache`` /
  ``cache`` callables must not pass f-strings or unhashable containers.

CLI: ``python -m repro_torch.analysis.lint src/repro_torch``.  Inline
suppression: ``# scarlint: ignore[SL002] -- reason``.  Grandfathered
violations live in the committed ``scarlint-torch-baseline.json`` (the
reference's ``scarlint-baseline.json`` is never read or written).  The
linter is host code: it imports neither torch nor JAX and touches no
device.
"""
from __future__ import annotations

from .baseline import BASELINE_FILENAME, Baseline, find_baseline_file
from .context import ModuleContext
from .findings import Finding
from .runner import LintReport, lint_paths, lint_source
from .rules import (MemoSig, ProjectIndex, Rule, default_rules, register,
                    rule_catalog)

__all__ = ["BASELINE_FILENAME", "Baseline", "Finding", "LintReport",
           "MemoSig", "ModuleContext", "ProjectIndex", "Rule",
           "default_rules", "find_baseline_file", "lint_paths",
           "lint_source", "register", "rule_catalog"]
