"""Host operator build, solvers, substrates and the plan/execute engine."""

from .engine import AzulEngine
from .formats import CSR, ELL
from .plan import PlanCache, SolvePlan, SolveSpec

__all__ = ["AzulEngine", "CSR", "ELL", "PlanCache", "SolvePlan", "SolveSpec"]
