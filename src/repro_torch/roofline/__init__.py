"""Roofline model of one step on the card (port of ``repro.roofline``;
``collect.py``, which reads collective bytes out of compiled HLO, waits for
a multi-card backend)."""
from .analyze import (  # noqa: F401
    HBM_BW, HBM_BYTES, LINK_BW, PEAK_FLOPS, RooflineRow, analytic_cell,
    load_cells, markdown_table, roofline_row,
)
