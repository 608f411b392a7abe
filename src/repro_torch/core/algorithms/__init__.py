"""Reconstruction algorithms of the port: CGLS, FDK and the SART family
(see ROADMAP for the rest of the reference's catalogue)."""

from .cgls import CGLSState, cgls, cgls_finalize, cgls_init, cgls_step
from .fdk import fdk, filter_projections
from .sart import (OSSARTState, ossart, ossart_finalize, ossart_init,
                   ossart_step, sart, sirt)
from .stepwise import (REGISTRY, StepwiseAlgorithm, checkpoint_state,
                       get_algorithm, restore_state)

__all__ = ["CGLSState", "cgls", "cgls_init", "cgls_step", "cgls_finalize",
           "fdk", "filter_projections", "sart", "sirt", "ossart",
           "OSSARTState", "ossart_init", "ossart_step", "ossart_finalize",
           "REGISTRY", "StepwiseAlgorithm", "checkpoint_state",
           "get_algorithm", "restore_state"]
