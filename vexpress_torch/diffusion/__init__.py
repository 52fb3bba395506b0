from .ddim import DDIMScheduler, SchedulerConfig
from .dpm_solver import DPMSolverMultistepScheduler, DpmState

__all__ = ["DDIMScheduler", "DPMSolverMultistepScheduler", "DpmState", "SchedulerConfig"]
