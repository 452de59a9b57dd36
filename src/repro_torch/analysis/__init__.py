"""Analysis of the port (the counterpart of ``repro.analysis``): the
``scarlint`` linter (``analysis.lint``), the cost of a traced program
(``analysis.trace_cost``, the stand-in for the reference's ``hlo_cost``)
and the roofline terms of a dry-run record (``analysis.roofline``), which
``launch.dryrun`` and ``launch.hillclimb`` use.
"""
from . import lint
