"""Samplers over a float64-precomputed coefficient tape."""
from dmtpu_torch.diffusions.ddim import DDIM, DDIMCFG
from dmtpu_torch.diffusions.ddpm import DDPM, DDPMCFG, cfg_double_merge
from dmtpu_torch.diffusions.dpm_solver import DPMSolverPP, DPMSolverPPCFG
from dmtpu_torch.diffusions.euler import EulerSampler
from dmtpu_torch.diffusions.flow import FlowMatching, FlowMatchingCFG
from dmtpu_torch.diffusions.flow_dpm import FlowDPMSolver, FlowDPMSolverCFG
from dmtpu_torch.diffusions.heun import HeunSampler
from dmtpu_torch.diffusions.pfdiff import PFDiffDDIM, PFDiffDDIMCFG
from dmtpu_torch.diffusions.schedule import get_beta_schedule, get_respaced_seq

__all__ = ["DDPM", "DDPMCFG", "DDIM", "DDIMCFG", "DPMSolverPP", "DPMSolverPPCFG", "EulerSampler",
           "FlowDPMSolver", "FlowDPMSolverCFG", "FlowMatching", "FlowMatchingCFG", "HeunSampler",
           "PFDiffDDIM", "PFDiffDDIMCFG", "cfg_double_merge", "get_beta_schedule",
           "get_respaced_seq"]
