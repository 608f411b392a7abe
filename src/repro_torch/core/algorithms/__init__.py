"""Reconstruction algorithms of the port: CGLS, FDK, the SART family,
FISTA-TV and ASD-POCS (the reference's whole catalogue)."""

from .asd_pocs import (ASDPOCSState, asd_pocs, asd_pocs_finalize,
                       asd_pocs_init, asd_pocs_step)
from .cgls import CGLSState, cgls, cgls_finalize, cgls_init, cgls_step
from .fdk import fdk, filter_projections
from .fista import (FISTAState, fista_tv, fista_tv_finalize, fista_tv_init,
                    fista_tv_step)
from .sart import (OSSARTState, ossart, ossart_finalize, ossart_init,
                   ossart_step, sart, sirt)
from .stepwise import (REGISTRY, StepwiseAlgorithm, checkpoint_state,
                       get_algorithm, restore_state)

__all__ = ["CGLSState", "cgls", "cgls_init", "cgls_step", "cgls_finalize",
           "fdk", "filter_projections", "sart", "sirt", "ossart",
           "OSSARTState", "ossart_init", "ossart_step", "ossart_finalize",
           "FISTAState", "fista_tv", "fista_tv_init", "fista_tv_step",
           "fista_tv_finalize", "ASDPOCSState", "asd_pocs", "asd_pocs_init",
           "asd_pocs_step", "asd_pocs_finalize",
           "REGISTRY", "StepwiseAlgorithm", "checkpoint_state",
           "get_algorithm", "restore_state"]
