"""Host operator build, solvers, substrates and the plan/execute engine.

The public surface is the JAX package's ``repro.core`` exports."""

from .commplan import CommPlan
from .engine import AzulEngine
from .formats import BCSR, CSR, ELL
from .plan import PlanCache, SolvePlan, SolveSpec, chunk_spec
from .registry import (
    PrecondDef,
    SolverDef,
    get_precond,
    get_solver,
    precond_names,
    register_precond,
    register_solver,
    solver_names,
)

__all__ = [
    # formats
    "CSR", "ELL", "BCSR",
    # engine + plan/execute API
    "AzulEngine", "CommPlan", "SolveSpec", "SolvePlan", "PlanCache", "chunk_spec",
    # registry
    "SolverDef", "PrecondDef",
    "register_solver", "register_precond",
    "get_solver", "get_precond",
    "solver_names", "precond_names",
]
