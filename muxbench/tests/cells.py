"""Reduced copies of the benchmark's cells for the CPU tests: the same
families, unit and traffic shape at widths a CPU run holds (head sizes
the card's kernels take, so the card tests can run them too).  A model
entry takes its family module's ``REDUCED`` sizes
(``muxbench/families/``), so a new family's cell is reduced with no
edit here."""
from __future__ import annotations

import copy

from muxbench import families, harness

REDUCED_UNIT = dict(max_slots=4, max_blocks_per_seq=16, chunk_tokens=16,
                    pool_blocks=1024)
REDUCED_TRAFFIC = dict(rate=6.0, fill_s=0.5,
                       prompt=dict(mean=24, sigma=0.9, min=4, max=96),
                       output=dict(mean=8, sigma=0.8, min=2, max=24))


def reduce(m: dict) -> dict:
    """Model entry ``m`` at its family's ``REDUCED`` sizes, in place."""
    m.update(copy.deepcopy(families.of(m).REDUCED))
    return m


def reduced_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    for m in cfg["models"].values():
        reduce(m)
    cfg["unit"].update(REDUCED_UNIT)
    cfg["dtype"] = "float32"
    traffic = dict(cell.traffic, **copy.deepcopy(REDUCED_TRAFFIC))
    return harness.Cell(cell.name, cell.chips, cfg, traffic,
                        cell.end_to_end, cell.per_layer)


def limited(name: str, limit: float = 1e-3) -> harness.Cell:
    """``reduced_cell`` held to ``limit`` for every model: the reduced
    models run in float32 against the float32 reference, so a sound run
    reads gaps at rounding, far under the cells' own limits, which are
    set for bfloat16 at published widths."""
    cell = reduced_cell(name)
    for m in cell.config["models"].values():
        m["max_logit_gap"] = limit
    return cell


def card_cell(name: str, layers: int = 8) -> harness.Cell:
    """The cell at its published widths, its unit and its traffic, with
    ``layers`` layers a model and a 2 s fill: what a test run on the
    card holds."""
    cell = harness.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    for m in cfg["models"].values():
        m["n_layers"] = layers
    traffic = dict(cell.traffic, fill_s=2.0)
    return harness.Cell(cell.name, cell.chips, cfg, traffic,
                        cell.end_to_end, cell.per_layer)
