"""Roofline analysis of the dry-run results (``launch.dryrun``), at the
H100's published peaks.

Per (arch x shape) single-pod cell, for one rank:

    compute term    = float FLOPs / 989.4 TFLOP/s + int8 ops / 1,979 TOP/s
    memory term     = bytes accessed / 3.35 TB/s      (unfused: an upper bound)
    memory lb       = argument bytes / 3.35 TB/s      (each input read once)
    collective term = wire bytes inside an NVLink domain / 900 GB/s
                      + wire bytes across domains / 50 GB/s

plus ``MODEL_FLOPS`` = 6 N_active D (train) or 2 N_active D (inference),
with the recurrences' FLOPs added analytically as the reference adds
them, and the counted/model ratio.  Float FLOPs are priced at the dense
bf16 peak, the card's fastest float rate, so the compute term is a
least time even where the port computes in float32 (attention scores).
These are host arithmetic on published figures, not measurements.

Usage:  PYTHONPATH=src python -m repro_torch.launch.roofline [--dir results/dryrun]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

from repro_torch import configs
from repro_torch.launch.dryrun import NVLINK_GBPS, SCALE_OUT_GBPS
from repro_torch.models import model_lib as M
from repro_torch.models.config import SHAPES
from repro_torch.pim.cost_model import GPU_HBM_BW as HBM_BW
from repro_torch.pim.cost_model import GPU_PEAK_FLOPS as PEAK_FLOPS

__all__ = ["PEAK_FLOPS", "PEAK_INT8_OPS", "HBM_BW", "LINK_BW",
           "SCALE_OUT_BW", "active_params", "recurrence_flops",
           "model_flops", "terms", "analyze", "render"]

# H100 SXM, 700 W (NVIDIA H100 Tensor Core GPU datasheet): the dense
# INT8 tensor-core peak.  The dense BF16 peak and the HBM3 bandwidth are
# ``pim/cost_model.py``'s, the links ``launch.dryrun``'s: NVLink 4 inside
# an 8-GPU HGX node, one 400 Gb/s NDR port per GPU across nodes.
PEAK_INT8_OPS = 1979e12
LINK_BW = NVLINK_GBPS * 1e9
SCALE_OUT_BW = SCALE_OUT_GBPS * 1e9

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../results/dryrun")


def _expert_params(cfg) -> int:
    if not cfg.n_experts:
        return 0
    f = cfg.moe_d_ff or cfg.d_ff
    n_moe_layers = sum(1 for k in cfg.pattern
                       if k in ("ae", "ar", "me", "ms", "as")) * cfg.n_super
    return n_moe_layers * cfg.n_experts * 3 * cfg.d_model * f


def _embed_params(cfg) -> int:
    mult = 1 if cfg.tie_embeddings else 2
    return mult * cfg.padded_vocab * cfg.d_model


def active_params(cfg) -> int:
    """Parameters a token reads: all but the embeddings and the experts
    it is not routed to."""
    total = M.param_count(cfg)
    ep = _expert_params(cfg)
    active_ep = ep * cfg.top_k / max(cfg.n_experts, 1)
    return int(total - _embed_params(cfg) - ep + active_ep)


def recurrence_flops(cfg, tokens: int) -> float:
    """Analytic per-token FLOPs of the recurrences (the Mamba scan, the
    xLSTM memories) over ``tokens``."""
    fl = 0.0
    per = cfg.n_super
    for kind in cfg.pattern:
        if kind in ("md", "me"):
            fl += per * 6 * cfg.d_inner * cfg.mamba_d_state
        if kind == "ms":  # Mamba-2: one decay a head, so 5 a state element
            fl += per * 5 * cfg.d_inner * cfg.mamba_d_state
        if kind == "xm":
            p = int(cfg.xlstm_proj_factor * cfg.d_model)
            dh = p // cfg.n_heads
            fl += per * 8 * cfg.n_heads * dh * dh
        if kind == "xs":
            p = int(cfg.xlstm_proj_factor * cfg.d_model)
            fl += per * 10 * p
    return fl * tokens


def model_flops(cfg, shape) -> float:
    """6 N_active D for a train step, 2 N_active D for prefill, 2 N_active
    per sequence for a decode step; plus the recurrences'."""
    n_act = active_params(cfg)
    d_tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        base = 6.0 * n_act * d_tokens
        base += 3 * recurrence_flops(cfg, d_tokens)
    elif shape.kind == "prefill":
        base = 2.0 * n_act * d_tokens
        base += recurrence_flops(cfg, d_tokens)
    else:  # decode: one token per sequence
        base = 2.0 * n_act * shape.global_batch
        base += recurrence_flops(cfg, shape.global_batch)
    return base


def terms(cell: Dict) -> Dict[str, float]:
    """The compute, memory (upper and lower bound) and collective seconds
    of one rank's step in a dry-run result."""
    flops = cell["flops_per_dev"]
    iops = cell.get("int_flops_per_dev", 0.0)
    cross = cell.get("cross_pod_bytes_per_dev", 0.0)
    return {
        "compute": (flops - iops) / PEAK_FLOPS + iops / PEAK_INT8_OPS,
        "memory": cell["bytes_per_dev"] / HBM_BW,
        "memory_lb": cell["mem"]["argument_bytes"] / HBM_BW,
        "collective": ((cell["wire_bytes_per_dev"] - cross) / LINK_BW
                       + cross / SCALE_OUT_BW),
    }


def _advice(dominant: str, cell: Dict) -> str:
    colls = cell.get("collectives", {})
    if dominant == "collective":
        big = max(colls.items(), key=lambda kv: kv[1]["wire_bytes"])[0] \
            if colls else "?"
        return f"cut {big} volume (sharding/dtype of the reduced tensor)"
    if dominant == "memory":
        return "raise arithmetic intensity: fuse/quantize, larger per-GPU tile"
    return "compute-bound: reduce remat recompute or use the int8 path"


def analyze(dir_: str) -> List[Dict]:
    out = []
    for arch in configs.ARCH_NAMES:
        cfg = configs.get(arch)
        for shape in SHAPES:
            path = os.path.join(dir_, f"{arch}__{shape.name}__single.json")
            if not os.path.exists(path):
                continue
            cell = json.load(open(path))
            row: Dict = {"arch": arch, "shape": shape.name,
                         "status": cell.get("status")}
            if cell.get("status") != "ok" or "flops_per_dev" not in cell:
                row["reason"] = cell.get("reason", cell.get("error", ""))[:60]
                out.append(row)
                continue
            n_dev = cell["n_devices"]
            mf = model_flops(cfg, shape)
            t = terms(cell)
            main = {k: t[k] for k in ("compute", "memory", "collective")}
            dominant = max(main, key=main.get)
            row.update(
                compute_s=t["compute"],
                memory_s=t["memory"],
                memory_lb_s=t["memory_lb"],
                collective_s=t["collective"],
                dominant=dominant,
                model_flops=mf,
                hlo_over_model=cell["flops_per_dev"] * n_dev / max(mf, 1.0),
                compute_fraction=t["compute"] / main[dominant],
                temp_gb=cell["mem"]["temp_bytes"] / 1e9,
                advice=_advice(dominant, cell),
            )
            out.append(row)
    return out


def render(rows: List[Dict]) -> str:
    lines = [
        "| arch | shape | compute (s) | memory ub (s) | memory lb (s) | "
        "collective (s) | dominant | MODEL_FLOPS | counted/MODEL | "
        "compute-frac | temp GB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("status") != "ok" or "dominant" not in r:
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                f"{r.get('status')}: {r.get('reason', '')} | | | | |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['memory_lb_s']:.3e} | "
            f"{r['collective_s']:.3e} | "
            f"{r['dominant']} | {r['model_flops']:.3g} | "
            f"{r['hlo_over_model']:.2f} | {r['compute_fraction']:.2f} | "
            f"{r['temp_gb']:.1f} |")
    ok = [r for r in rows if "dominant" in r]
    if ok:
        worst = min(ok, key=lambda r: r["compute_fraction"])
        coll = max(ok, key=lambda r: r["collective_s"])
        lines.append("")
        lines.append(f"* worst compute fraction: {worst['arch']} x "
                     f"{worst['shape']} ({worst['compute_fraction']:.2f}, "
                     f"dominant {worst['dominant']})")
        lines.append(f"* most collective-bound: {coll['arch']} x "
                     f"{coll['shape']} ({coll['collective_s']:.3e}s on wire)")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=RESULTS_DIR)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = analyze(args.dir)
    md = render(rows)
    print(md)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md + "\n")


if __name__ == "__main__":
    main()
