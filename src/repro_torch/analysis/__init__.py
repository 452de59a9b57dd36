"""Static analysis of the port: the ``scarlint`` linter (``analysis.lint``).

The counterpart of ``repro.analysis``.  Its roofline and HLO-cost modules
read the dry-run records that ``launch/dryrun.py`` writes, so they are
ported with that tool.
"""
from . import lint
