"""Bytes-per-scan communication model for the distributed engines.

Every distributed step's collectives are known by construction, so
per-scan payload bytes follow from the config and mesh.  This module
enumerates them per engine; `docs/scaling_cpu.md`'s comm section is
generated from these tables (scripts/scaling_table.py), and
tests/test_comm_model.py pins the enumeration against the engines' actual
collective structure.  The bytes are device-neutral; collective TIME comes
from a profiler trace on the devices themselves.

Layout rule recap (parallel/dcn.py): the particle axis 'p' maps to the
host dimension (the inter-host network), map tiles 'm' stay inside a host.
So the inter-host rows are exactly the axis='p' rows.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..config import SlamConfig


@dataclasses.dataclass(frozen=True)
class CollectiveRow:
    """One collective's per-scan, per-device payload."""

    engine: str
    collective: str        # psum | all_gather | ppermute | pmax
    axis: str              # 'p' (inter-host candidate) | 'm' (intra-host)
    bytes_per_scan: int    # payload bytes moved per device per scan
    when: str              # 'every scan' | 'resampling scans only'
    what: str


def _weight_stat_rows(engine: str, n_p: int, p_loc: int) -> List[CollectiveRow]:
    """The collectives every particle-sharded engine shares (weight
    normalization, Neff, weighted pose, strongest-particle election,
    gated resampling).  Payloads in f32."""
    rows = [
        CollectiveRow(engine, "pmax+psum", "p", 4 * (1 + 1 + 1 + 3 + 1),
                      "every scan",
                      "weight max, normalizer, Neff term, weighted pose "
                      "(3,), best-index psum"),
        CollectiveRow(engine, "all_gather", "p", 4 * 4 * n_p,
                      "every scan",
                      "strongest-particle election: (score, pose) per "
                      "shard"),
        CollectiveRow(engine, "all_gather", "p", 16 * p_loc * n_p,
                      "resampling scans only",
                      "systematic resampling: log-weights (4 B) + poses "
                      "(12 B) per particle — gated inside lax.cond since "
                      "round 5"),
    ]
    return rows


def _halo_rows(engine: str, cfg: SlamConfig) -> List[CollectiveRow]:
    h = cfg.map.cells_y
    k = cfg.map.likelihood_radius
    return [
        CollectiveRow(engine, "ppermute", "m",
                      4 * h * k * 2 * 2, "every scan",
                      f"blur halos: {k}-column exchange x2 directions x2 "
                      "fields (occupancy + evidence)"),
        CollectiveRow(engine, "ppermute", "m", 4 * h * 1 * 2, "every scan",
                      "LL bilinear halo: 1 column each direction"),
    ]


def comm_table(cfg: SlamConfig, n_p: int, n_m: int,
               engine: str) -> List[CollectiveRow]:
    """Per-scan collective payloads for one engine on a (p=n_p, m=n_m)
    mesh.  engine in {'shmap', 'shmap_surface', 'tiled',
    'surface_sharded'}."""
    assert cfg.num_particles % n_p == 0
    p_loc = cfg.num_particles // n_p
    mc = cfg.matcher
    rows = _weight_stat_rows(engine, n_p, p_loc)

    if engine == "shmap":
        pass                        # map replicated: no 'm' collectives
    elif engine == "shmap_surface":
        rows.append(CollectiveRow(
            engine, "psum", "p", 4 * 3, "every scan",
            "previous-cloud weighted mean (volume center)"))
    elif engine == "tiled":
        rows += _halo_rows(engine, cfg)
        # per-particle stage-score psums over 'm'
        coarse = mc.coarse_nt * mc.coarse_nxy * mc.coarse_nxy
        fine = mc.fine_nt * mc.fine_nxy * mc.fine_nxy
        grids = coarse + (1 + mc.extra_refine_stages) * fine
        rows.append(CollectiveRow(
            engine, "psum", "m", 4 * grids * p_loc, "every scan",
            f"matcher partial scores: {grids} candidate cells x "
            f"{p_loc} local particles"))
    elif engine == "surface_sharded":
        # NB: no blur-halo ppermutes — the field is built crop-locally
        # from the psum-assembled raw log-odds crop (round 5)
        rows.append(CollectiveRow(
            engine, "psum", "p", 4 * 3, "every scan",
            "previous-cloud weighted mean (volume center)"))
        h, w = cfg.map.cells_y, cfg.map.cells_x
        if mc.surface_crop_cells > 0:       # 0 = full map (models/shared)
            hc, wc = min(mc.surface_crop_cells, h), min(
                mc.surface_crop_cells, w)
        else:
            hc, wc = h, w
        r = cfg.map.likelihood_radius
        hce, wce = min(hc + 2 * r, h), min(wc + 2 * r, w)
        rows.append(CollectiveRow(
            engine, "psum", "m", 4 * hce * wce, "every scan",
            f"raw log-odds crop assembly: ({hce}, {wce}) incl. blur halo"))
        nt_loc = -(-mc.surface_nt // n_m)
        rows.append(CollectiveRow(
            engine, "all_gather", "m", 4 * nt_loc * n_m * hc * wc,
            "every scan",
            f"likelihood volume: {nt_loc} bins/shard x {n_m} shards x "
            f"({hc}, {wc})"))
    else:
        raise ValueError(engine)
    return rows
