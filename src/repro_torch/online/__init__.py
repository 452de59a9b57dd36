"""Online scheduling subsystem of the port: trace-driven dynamic multi-tenancy.

The counterpart of ``repro.online``, with the same modules and public
names; every re-plan runs ``repro_torch.core.schedule`` on a device
(``simulate(..., device=)``, ``simulate_fleet(..., device=)``): CUDA by
default, raising without a card, the CPU only when asked for.

SCAR's two application settings are inherently dynamic — datacenter tenants
arrive and depart, AR/VR models fire on per-sensor frame cadences — yet the
static pipeline plans one fixed Table II scenario and stops.  This package
adds the discrete-event layer on top of it:

* ``traces``       — seeded trace generators + a serializable Trace/Event IR
  (Poisson tenant churn over the datacenter model zoo; periodic frame
  cadences with deadlines for the AR/VR scenarios).
* ``rescheduler``  — incremental re-scheduling at epoch boundaries through
  the warm-startable ``scheduler.schedule(prev_end=..., window_memo=...)``
  entry (warm per-process caches + plan/window/candidate memoisation), with
  a ``cold`` from-scratch oracle the warm path is parity-tested against.
* ``simulator``    — the event loop: maintains the active tenant set,
  re-plans on arrival/departure epochs, and accounts execution between
  epochs with the exact ``cost.evaluate_schedule`` machinery.
* ``metrics``      — QoS accounting over a finished simulation: per-model
  p50/p99 latency, deadline-miss rates, aggregate EDP, re-plan overhead.
* ``slo``          — tenant service classes (latency-critical / standard /
  best-effort) and the class-weighted serving objective; drives
  sub-iteration preemption (``simulator.OnlinePolicy``), trace-driven MCM
  reconfiguration (``rescheduler.SLORescheduler``) and the per-class /
  class-weighted metrics (``metrics.slo_report``).
* ``fleet``        — open-loop multi-package serving: streams a (possibly
  unmaterialised) churn event sequence through many ``PackageServer``
  loops behind a router with admission control and power/area-budgeted
  autoscaling (``repro_torch.core.provision``); bounded memory at any
  trace length.
"""
from .traces import (Event, Trace, frame_cadence_trace,  # noqa: F401
                     iter_frame_cadence, iter_open_loop_churn,
                     iter_poisson_churn, merge_events,
                     open_loop_churn_trace, poisson_churn_trace)
from .rescheduler import (Rescheduler, ReplanRecord,  # noqa: F401
                          SLORescheduler)
from .simulator import (EpochRecord, OnlinePolicy,  # noqa: F401
                        PackageServer, SimResult, SLOSample,
                        iteration_split, simulate)
from .metrics import (ClassQoS, ModelQoS, QoSReport,  # noqa: F401
                      SLOReport, StreamingStats, qos_report, slo_report)
from .slo import (SLO_CLASSES, SLOClass, class_weighted_score,  # noqa: F401
                  get_slo)
from .fleet import (FleetConfig, FleetReport,  # noqa: F401
                    PackageSummary, simulate_fleet)
