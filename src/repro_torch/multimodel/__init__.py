"""SCAR as the placement engine for multi-model serving (counterpart of
``repro.multimodel``): plan several LMs onto a pod with the scheduler, then
serve each on what it was given (on one card, at tp = 1)."""
from .orchestrator import (TPU_NPE, TPU_PKG, ModelPlacement, PodPlan,
                           ServeRequest, arch_to_workload, make_pod_mcm,
                           plan, realize, tpu_chip_classes)

__all__ = ["TPU_NPE", "TPU_PKG", "ModelPlacement", "PodPlan", "ServeRequest",
           "arch_to_workload", "make_pod_mcm", "plan", "realize",
           "tpu_chip_classes"]
