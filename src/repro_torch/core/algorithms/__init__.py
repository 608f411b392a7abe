"""Reconstruction algorithms of the port (CGLS so far; see ROADMAP)."""

from .cgls import CGLSState, cgls, cgls_finalize, cgls_init, cgls_step
from .stepwise import (REGISTRY, StepwiseAlgorithm, checkpoint_state,
                       get_algorithm, restore_state)

__all__ = ["CGLSState", "cgls", "cgls_init", "cgls_step", "cgls_finalize",
           "REGISTRY", "StepwiseAlgorithm", "checkpoint_state",
           "get_algorithm", "restore_state"]
