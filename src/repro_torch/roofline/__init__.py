"""Roofline model of one step (port of ``repro.roofline``): ``analyze``
(the H100's figures, ``roofline_row``) and ``collect`` (the collective
bytes of a train step on a process grid, from the step's design where
the JAX package parses compiled HLO)."""
from .analyze import (  # noqa: F401
    HBM_BW, HBM_BYTES, LINK_BW, PEAK_FLOPS, RooflineRow, analytic_cell,
    load_cells, markdown_table, roofline_row,
)
from .collect import train_step_bytes  # noqa: F401
