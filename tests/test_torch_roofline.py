"""The port's roofline model (``repro_torch.roofline.analyze``) held to the
JAX package's (``repro.roofline.analyze``) on the CPU.

``_active_params`` and ``analytic_cell`` are the JAX arithmetic on the
port's own ``ModelConfig``: equal, exactly, for all ten architectures at
their published configs, every cell of ``cells(cfg)``, ``grad_accum`` 1
and 2, remat on and off.  ``roofline_row`` on one cell dict gives JAX's
FLOPs and bytes, each term scaled by the ratio of the two packages'
constants (the H100 SXM's against TPU v5e's).  A mesh of several devices
with no collective bytes has no collective term (never 0); one device has
0.  PERF.md's hand-worked floors come out of the code: 208.0 ms for the
granite-3-8b training step (6 N T at the bf16 peak) and 5.00 ms for its
decode step (weights and KV cache at 3.35 TB/s).
"""

import json

import pytest

from repro import configs as jconfigs
from repro.roofline import analyze as JA
from repro_torch import configs
from repro_torch.roofline import analyze as A
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = sorted(configs.names())
CELLS = [(a, s) for a in ARCHS for s in configs.cells(configs.get(a))]


@pytest.mark.parametrize("name", ARCHS)
def test_active_params_equal_jax(name):
    cfg, jcfg = configs.get(name), jconfigs.get(name)
    assert cfg.n_params() == jcfg.n_params()
    assert A._active_params(cfg) == JA._active_params(jcfg)
    assert A._active_params(cfg.smoke()) == JA._active_params(jcfg.smoke())


@pytest.mark.parametrize("name,shape", CELLS)
@pytest.mark.parametrize("ga", [1, 2])
def test_analytic_cell_equals_jax(name, shape, ga):
    kind, seq, batch = configs.SHAPES[shape]
    for remat in (True, False):
        cfg = configs.get(name).replace(remat=remat)
        jcfg = jconfigs.get(name).replace(remat=remat)
        assert A.analytic_cell(cfg, kind, seq, batch, ga) == \
            JA.analytic_cell(jcfg, kind, seq, batch, ga)


def _cell(name, shape, devices=256, mesh="single", collectives=3.0e9, temp=5.0e9):
    kind, seq, batch = configs.SHAPES[shape]
    return {"arch": name, "shape": shape, "mesh": mesh, "devices": devices,
            "kind": kind, "seq": seq, "global_batch": batch, "grad_accum": 2,
            "memory_analysis": {"argument_size_in_bytes": 6.0e9,
                                "output_size_in_bytes": 6.5e9,
                                "alias_size_in_bytes": 6.0e9,
                                "temp_size_in_bytes": temp},
            "cost_analysis": {"flops": 1.25e12},
            "collectives": (None if collectives is None
                            else {"total_bytes": collectives})}


@pytest.mark.parametrize("name,shape", CELLS)
def test_roofline_row_is_jax_scaled_by_the_constants(name, shape):
    cell = _cell(name, shape)
    row = A.roofline_row(cell, configs.get(name))
    jrow = JA.roofline_row(cell, jconfigs.get(name))
    for f in ("arch", "shape", "mesh", "chips", "model_flops", "analytic_flops",
              "hlo_flops_raw", "ratio", "hbm_used"):
        assert getattr(row, f) == getattr(jrow, f), f
    rel = lambda a, b: abs(a - b) <= 1e-12 * abs(b)
    assert rel(row.t_compute, jrow.t_compute * JA.PEAK_FLOPS / A.PEAK_FLOPS)
    assert rel(row.t_memory, jrow.t_memory * JA.HBM_BW / A.HBM_BW)
    assert rel(row.t_collective, jrow.t_collective * JA.ICI_BW / A.LINK_BW)
    terms = {"compute": row.t_compute, "memory": row.t_memory,
             "collective": row.t_collective}
    assert row.dominant == max(terms, key=terms.get)
    assert "missing" not in row.note and row.counted_flops is None
    assert row.fits_hbm is (row.hbm_used <= 80e9)
    want = row.model_flops / A.PEAK_FLOPS / max(terms.values())
    assert rel(row.frac_of_roofline(), want)


def test_the_h100_constants():
    assert (A.PEAK_FLOPS, A.HBM_BW, A.HBM_BYTES, A.LINK_BW) == \
        (989.4e12, 3.35e12, 80e9, 450e9)


@pytest.mark.parametrize("name,shape", [("granite-3-8b", "train_4k"),
                                        ("mamba2-370m", "decode_32k")])
def test_missing_collectives_are_never_zero(name, shape):
    cfg = configs.get(name)
    row = A.roofline_row(_cell(name, shape, collectives=None), cfg)
    assert row.t_collective is None
    assert row.dominant == ("compute" if row.t_compute >= row.t_memory
                            else "memory")
    assert "collective term missing" in row.note
    assert row.t_bound() == max(row.t_compute, row.t_memory)
    assert "missing" in A.markdown_table([row])
    # one device: no collective at all
    one = A.roofline_row(_cell(name, shape, devices=1, mesh="card",
                               collectives=None), cfg)
    assert one.t_collective == 0.0 and "missing" not in one.note
    assert one.t_compute == pytest.approx(row.t_compute * 256, rel=1e-12)


def test_unknown_temporaries_leave_the_fit_unknown():
    row = A.roofline_row(_cell("granite-3-8b", "train_4k", temp=None),
                         configs.get("granite-3-8b"))
    assert row.fits_hbm is None and row.hbm_used == 6.5e9
    assert "| ? |" in A.markdown_table([row])
    big = A.roofline_row(_cell("granite-3-8b", "train_4k", temp=90e9),
                         configs.get("granite-3-8b"))
    assert big.fits_hbm is False


def test_perf_md_floors_come_from_the_code():
    """granite-3-8b, batch 4: training at 1024 tokens a sequence, 6 N T at
    the bf16 peak; decode over phase 9b's 48-slot cache, bytes."""
    cfg = configs.get("granite-3-8b")
    train = A.roofline_row({"arch": "granite-3-8b", "shape": "4x1024",
                            "mesh": "card", "devices": 1, "kind": "train",
                            "seq": 1024, "global_batch": 4}, cfg)
    assert round(train.model_flops / A.PEAK_FLOPS * 1e3, 1) == 208.0
    assert train.dominant == "compute" and train.t_collective == 0.0
    dec = A.roofline_row({"arch": "granite-3-8b", "shape": "4x48",
                          "mesh": "card", "devices": 1, "kind": "decode",
                          "seq": 48, "global_batch": 4}, cfg)
    assert dec.dominant == "memory"
    assert round(dec.t_bound() * 1e3, 2) == 5.01
    assert abs(dec.t_bound() * 1e3 - 5.00) <= 0.01 * 5.00


def test_load_cells_and_table(tmp_path):
    cells = [_cell("granite-3-8b", "train_4k"), _cell("mamba2-370m", "decode_32k")]
    for i, c in enumerate(cells):
        (tmp_path / f"c{i}.json").write_text(json.dumps(c))
    (tmp_path / "c__probe1.json").write_text(json.dumps(cells[0]))
    (tmp_path / "notes.txt").write_text("x")
    got = A.load_cells(str(tmp_path))
    assert got == JA.load_cells(str(tmp_path)) == cells
    rows = [A.roofline_row(c, configs.get(c["arch"])) for c in got]
    table = A.markdown_table(rows)
    jtable = JA.markdown_table([JA.roofline_row(c, jconfigs.get(c["arch"]))
                                for c in got])
    assert table.splitlines()[:2] == jtable.splitlines()[:2]
    assert len(table.splitlines()) == 4
    assert all(r.arch in table for r in rows)
