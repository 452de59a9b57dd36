"""SCAR core ported to PyTorch: multi-model scheduling for heterogeneous MCMs."""
from .chiplet import (ALL_PATTERNS, HET_PATTERNS, MCM, ChipletClass, Dataflow,
                      PackageParams, make_mcm)
from .cost import (ModelWindowPlan, ScheduleResult, WindowPlan, WindowResult,
                   evaluate_schedule, evaluate_window)
from .evaluator import eval_candidates, resolve_backend
from .maestro import CostDB, build_cost_db, cost_db_from_arrays, \
    expected_latency
from .reconfig import greedy_pack, uniform_pack, validate_assignment
from .provision import provision
from .scheduler import (ScheduleOutcome, SearchConfig, clear_caches,
                        final_anchors, run_config, schedule,
                        schedule_incremental, standalone_schedule)
from .scenarios import (ARVR, DATACENTER, SCENARIO_NAMES, all_scenarios,
                        get_scenario)
from .workload import Layer, Model, OpType, Scenario
from .refine import refine
