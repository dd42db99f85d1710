"""Architecture configs (exact published dims) + shape registry: the
port's own copy of ``repro.configs``."""
from .base import SHAPES, cells, get, get_smoke, names, subquadratic  # noqa: F401
