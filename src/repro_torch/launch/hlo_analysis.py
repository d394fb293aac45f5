"""Roofline terms of a dry-run cell, per rank (port of
``repro/launch/hlo_analysis.py``; the file name kept so a reader finds
it).  The reference reads post-optimization HLO; the port reads what the
dry-run recorded while its step ran on fake tensors:

* ``collective_bytes(records)``: a list of ``(kind, bytes a rank)``, one
  a collective, summed by the reference's kinds (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``) and their total; a collective's bytes are those
  of its result on the rank, as the reference counts HLO result shapes;
* ``roofline_terms``: compute, memory and collective seconds a rank on
  ``HW``;
* ``sharded_stage_traffic``: the modelled traffic of a feature-sharded
  SPM schedule (plain arithmetic over ``core.eligibility.plan_steps``),
  the reference's function line for line;
* ``cost_terms`` and ``memory_terms``: the dry-run's per-rank flop and
  byte counts in the reference's ``cost_analysis_terms`` and
  ``memory_analysis_terms`` shape.

``HW`` holds the card's data-sheet peaks, not measurements: NVIDIA's H100
SXM data sheet (dense rates, no sparsity), for the card every chip record
of this repo names, ``NVIDIA H100 80GB HBM3, 700.00 W`` (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``).  ``link_bw`` is
NVLink 4's 900 GB/s a card both ways together, 450 GB/s each way.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from repro_torch.core.eligibility import OVERLAP_ROW_BLOCKS

__all__ = ["HW", "COLLECTIVE_KINDS", "collective_bytes", "roofline_terms",
           "sharded_stage_traffic", "cost_terms", "memory_terms"]

HW = {
    "card": "NVIDIA H100 80GB HBM3, 700.00 W",
    "source": "NVIDIA H100 SXM data sheet (dense, no sparsity); "
              "not measured",
    "peak_flops": 989e12,      # bf16 tensor-core flop/s
    "hbm_bw": 3.35e12,         # bytes/s
    "link_bw": 450e9,          # NVLink 4, bytes/s one way
}

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Bytes a rank by kind over recorded ``(kind, bytes)`` collectives,
    with their ``total``."""
    out = {k: 0 for k in COLLECTIVE_KINDS}
    for kind, nbytes in records:
        if kind not in out:
            raise ValueError(f"unknown collective kind {kind!r}")
        out[kind] += int(nbytes)
    out["total"] = sum(out[k] for k in COLLECTIVE_KINDS)
    return out


def sharded_stage_traffic(n_local: int, batch_rows: int, steps,
                          dtype_bytes: int = 4,
                          hw: Optional[dict] = None, *,
                          use_diag: bool = False,
                          use_bias: bool = False,
                          in_width: Optional[int] = None,
                          out_width: Optional[int] = None,
                          fold_boundaries: bool = True,
                          overlap: bool = False,
                          n_row_blocks: Optional[int] = None) -> Dict:
    """Modelled per-rank traffic of a feature-sharded SPM schedule, the
    reference's model (its docstring has the derivation).

    ``steps`` is ``core.eligibility.plan_steps(...)``: a ``("cross", ell,
    k)`` stage moves the rank's whole ``(batch_rows, n_local)`` slab to
    its XOR partner; a ``("local", off, strides)`` run costs one read and
    one write of the slab.  With ``fold_boundaries`` the diagonals and
    bias ride the boundary steps, and only the cut of the assembled output
    to ``out_width`` (and, on a cross-starting schedule, the explicit d_in
    product and the window build) is charged.  ``overlap`` pipelines
    ``n_row_blocks`` row blocks (default ``OVERLAP_ROW_BLOCKS``); the
    exposed remainder is

        exposed = max(bottleneck - compute_hide, bottleneck / nb)
                  + (total - bottleneck) / nb

    clamped to ``[0, total]``, ``hidden = total - exposed``.  Seconds are
    on ``hw`` (``HW``: HBM against the link)."""
    hw = hw or HW
    if overlap and n_row_blocks is None:
        n_row_blocks = OVERLAP_ROW_BLOCKS
    nb = n_row_blocks if overlap else 1
    slab = batch_rows * n_local * dtype_bytes
    stages = []
    link_bytes: Dict[int, int] = {}
    coll_total = hbm_total = 0
    for step in steps:
        if step[0] == "cross":
            stages.append({"kind": "cross", "stage": step[1], "k": step[2],
                           "permute_bytes": slab, "hbm_bytes": 2 * slab})
            link_bytes[step[2]] = link_bytes.get(step[2], 0) + slab
            coll_total += slab
        else:
            stages.append({"kind": "local", "stage": step[1],
                           "n_stages": len(step[2]), "permute_bytes": 0,
                           "hbm_bytes": 2 * slab})
        hbm_total += 2 * slab
    if nb <= 1 or not link_bytes:
        exposed = coll_total
    else:
        bottleneck = max(link_bytes.values())
        compute_hide = ((hbm_total / hw["hbm_bw"]) * hw["link_bw"]
                        * (nb - 1) / nb)
        exposed = (max(bottleneck - compute_hide, bottleneck / nb)
                   + (coll_total - bottleneck) / nb)
        exposed = min(max(exposed, 0.0), coll_total)
    exposed = int(round(exposed))
    # pro-rated per stage; the last cross row takes the rounding remainder
    crosses = [row for row in stages if row["kind"] == "cross"]
    shared = 0
    for row in crosses:
        row["exposed_bytes"] = int(round(
            exposed * row["permute_bytes"] / coll_total))
        shared += row["exposed_bytes"]
    if crosses:
        crosses[-1]["exposed_bytes"] += exposed - shared
    boundary = 0
    first_local = bool(steps) and steps[0][0] == "local"
    if fold_boundaries:
        if use_diag and not first_local:
            boundary += 2 * slab               # the explicit d_in product
        if in_width is not None and not first_local:
            boundary += slab + batch_rows * min(n_local, in_width) \
                * dtype_bytes                  # the window build
        if out_width is not None:
            boundary += 2 * min(slab, batch_rows * out_width * dtype_bytes)
    else:
        n_elementwise = (2 if use_diag else 0) + (1 if use_bias else 0)
        boundary += n_elementwise * 2 * slab
        if in_width is not None:
            boundary += slab + batch_rows * min(n_local, in_width) \
                * dtype_bytes
        if out_width is not None:
            boundary += slab + batch_rows * min(n_local, out_width) \
                * dtype_bytes
    hbm_total += boundary
    return {"stages": stages,
            "overlap": bool(overlap),
            "n_row_blocks": nb,
            "permute_bytes_per_chip": coll_total,
            "exposed_permute_bytes_per_chip": exposed,
            "hidden_permute_bytes_per_chip": coll_total - exposed,
            "boundary_bytes_per_chip": boundary,
            "hbm_bytes_per_chip": hbm_total,
            "collective_s": coll_total / hw["link_bw"],
            "exposed_collective_s": exposed / hw["link_bw"],
            "memory_s": hbm_total / hw["hbm_bw"]}


def roofline_terms(flops_per_rank: float, bytes_per_rank: float,
                   coll_bytes_per_rank: float,
                   hw: Optional[dict] = None) -> Dict[str, float]:
    """Compute, memory and collective seconds a rank on ``hw``, the
    dominant term, and compute's share of the bound."""
    hw = hw or HW
    t_c = flops_per_rank / hw["peak_flops"]
    t_m = bytes_per_rank / hw["hbm_bw"]
    t_x = coll_bytes_per_rank / hw["link_bw"]
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x}
    terms["dominant"] = max(terms, key=terms.get)
    bound = max(t_c, t_m, t_x)
    terms["roofline_fraction"] = (t_c / bound) if bound > 0 else 0.0
    return terms


def cost_terms(flops: float, bytes_accessed: float) -> Dict[str, float]:
    """A rank's counted flops and bytes moved, the reference's
    ``cost_analysis_terms`` keys."""
    return {"flops": float(flops), "bytes_accessed": float(bytes_accessed)}


def memory_terms(state_bytes: int, peak_bytes: int) -> Dict[str, int]:
    """A rank's resident state (its local shards) and live peak during
    the step, bytes."""
    return {"state_bytes": int(state_bytes), "peak_bytes": int(peak_bytes)}
