"""Top-k MoE, with expert parallelism over the "model" mesh axis.

Each token's router logits are a float32 product; it picks its ``top_k``
experts (ties to the lower expert index) and weighs them by a softmax
over the k logits.  Each expert accepts at most ``capacity`` tokens, in
token order; the rest are dropped for that expert (the router's other
choices still serve them).  The experts run grouped: one gather puts
every expert's accepted tokens into an ``(E, capacity + 1, d)`` buffer,
three batched products in the compute dtype run every expert at once,
and each token adds its experts' weighted float32 outputs in ascending
expert order (the order of an expert-after-expert loop, so the sums are
that loop's); dispatch is a gather, not a one-hot product.  A layer costs
the same few dozen launches at any expert count.

Without a mesh (or at model 1) one process runs every expert: the
reference's ``mesh is None`` branch.  Under a mesh whose ``"model"`` axis
has ``R > 1`` ranks each rank runs only its ``E / R`` experts, from
``rank * E / R`` on: the reference's ``shard_map`` branch.  The tokens
split over the data axes when those divide ``B * S`` (each data rank
routes only its rows, with the capacity of its own row count, so
capacities and drops differ from the meshless branch exactly as the
reference's do), every rank's partial is summed over the model group in
the compute dtype (the reference's ``psum``: with two ranks the bf16 sum
of two bf16 partials, not the float32 sum of the meshless branch), and
the rows are gathered back over the data group.  In the sharded trainer
the rows a rank holds are already its block of the batch (the tree's
``dist.zero.Gathered`` view says so in ``row_axes``), so they are routed
as they are and not gathered back.  The sum and the gather are autograd functions
(``dist.zero.psum``, ``gather_rows``), so the block trains.

With ``moe_fsdp_gather`` on a ``"data"`` axis larger than 1 the
reference's ZeRO-3 branch runs: the expert-parallel path even at model 1
(tokens split over the data axes, the capacity of the local count), and,
on a sharded tree (``dist.zero.Gathered``), each rank gathers only its
``E / R`` experts of ``w1``/``w3``/``w2`` over ``"data"``
(``dist.zero.gather_experts``), never all ``E`` whole.  On a replicated
tree the rank slices its experts from the whole leaves, which is the
same arithmetic.

**The trash slot.** Every token that is not routed to an expert, or that
overflows its capacity, lands in the expert's extra slot ``capacity``.
The reference fills the slot-to-token map and the expert's input buffer
with scatters whose duplicate indices XLA resolves on the CPU by letting
the *last* token win, so when the batch's last token overflows an expert
its contribution is kept, through the trash row, while every earlier
overflow token is dropped.  The port reproduces that rule
deterministically: the slot-to-token map is a ``scatter_reduce`` with
``amax`` of the token indices (the largest index is the last writer), and
the expert's buffer is *gathered* through that map.  A token reads its
output back from the slot it was served in, or from the trash slot it
won; a token the trash slot took but did not route there adds nothing.

The dispatch is fixed-shape: no ``nonzero``, no ``.item()``, no host
sync.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.dist import context as dctx
from repro_torch.dist.zero import Gathered, gather_experts, gather_rows, psum
from repro_torch.models.layers import activation
from repro_torch.runtime.trace import span

__all__ = ["expert_capacity", "moe_ffn", "router_top_k"]


def expert_capacity(t_tokens: int, top_k: int, capacity_factor: float,
                    n_experts: int) -> int:
    """Tokens one expert accepts out of ``t_tokens``: ``ceil(T * k * cf /
    E)`` as the reference writes it (a float floor division), at least 8
    and never above ``t_tokens``, so tiny decode batches are never
    dropped."""
    return min(t_tokens,
               max(int(-(-t_tokens * top_k * capacity_factor // n_experts)),
                   8))


def router_top_k(x2d, router, k: int):
    """``(softmaxed top-k weights, top-k expert ids)`` of (T, d) tokens.

    The logits are a true float32 product (TF32 would round the operands
    to a 10-bit mantissa and flip routing near ties).  ``jax.lax.top_k``
    puts the lower index first among equal values; a stable descending
    sort does the same, ``torch.topk`` does not promise it."""
    if x2d.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("MoE routing needs float32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is True")
    logits = x2d.to(torch.float32) @ router.to(torch.float32)
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[:, :k], dim=-1), ids[:, :k]


def _slot_map(any_hit, tok, capacity: int):
    """Each expert's (capacity + 1,) slot -> token map over its (E, T)
    row of hits: the hits in token order up to ``capacity``, then the
    trash slot with the largest token index sent there (the reference's
    last writer: an overflow or a token not routed here); ``T`` marks an
    empty slot.  Returns (E, capacity + 1)."""
    t = any_hit.shape[-1]
    slot = torch.cumsum(any_hit, -1) - 1
    slot = torch.where(any_hit & (slot < capacity), slot, capacity)
    tok_of_slot = torch.full(any_hit.shape[:-1] + (capacity + 1,), -1,
                             dtype=tok.dtype, device=tok.device
                             ).scatter_reduce(-1, slot, tok.expand_as(slot),
                                              reduce="amax")
    return torch.where(tok_of_slot < 0, t, tok_of_slot)


def _dispatch(top_ids, capacity: int, n_e: int, e_base: int = 0):
    """Where the experts ``e_base`` to ``e_base + n_e - 1`` take the
    (T, k) routes ``top_ids``: each expert's (capacity + 1,) slot map
    ``tok_of_slot`` (E, capacity + 1), and for each token's experts in
    ascending order (``order`` (T, k) indexes ``top_ids``' columns) the
    flat slot ``rows`` (T, k) its output is read back from: the token's
    slot, or the trash slot it won, or ``E * (capacity + 1)`` where it was
    dropped or the expert is not held here."""
    t, dev = top_ids.shape[0], top_ids.device
    slots = capacity + 1
    tok = torch.arange(t, device=dev)
    experts = torch.arange(e_base, e_base + n_e, device=dev)
    any_hit = (top_ids[:, :, None] == experts).any(1).T    # (E, T)
    tok_of_slot = _slot_map(any_hit, tok, capacity)        # (E, cap + 1)
    ids, order = torch.sort(top_ids, dim=1)                # (T, k)
    local = ids - e_base
    mine = (local >= 0) & (local < n_e)
    local = local.clamp(0, n_e - 1)
    rank = (torch.cumsum(any_hit, 1) - 1).T.gather(1, local)
    won = tok_of_slot[:, capacity][local] == tok[:, None]
    served = mine & ((rank < capacity) | won)
    rows = torch.where(served, local * slots + rank.clamp(max=capacity),
                       n_e * slots)
    return tok_of_slot, rows, order


def _local_moe(x, top_ids, top_w, w1, w2, w3, *, capacity: int,
               act_name: str, e_base: int = 0):
    """The experts ``e_base`` to ``e_base + len(w1) - 1`` over (T, d)
    tokens, grouped; returns the (T, d) float32 sum over those experts of
    each token's weighted expert outputs, added in ascending expert
    order."""
    d, n_e = x.shape[1], w1.shape[0]
    act = activation(act_name)
    tok_of_slot, rows, order = _dispatch(top_ids, capacity, n_e, e_base)

    # every expert's slots, gathered (an empty slot reads the zero row; a
    # trash slot won by a token not routed there is never read back)
    buf = torch.cat([x, x.new_zeros((1, d))])[tok_of_slot]
    h = act(torch.bmm(buf, w1.to(x.dtype)))
    if w3 is not None:
        h = h * torch.bmm(buf, w3.to(x.dtype))
    # the outputs in the compute dtype, with a zero row for dropped pairs;
    # each is widened to float32 exactly where its weight multiplies it
    y = torch.bmm(h, w2.to(x.dtype)).reshape(-1, d)       # (E (cap + 1), d)
    y = torch.cat([y, y.new_zeros((1, d))])
    w = top_w.gather(1, order)[..., None]
    # (T, k, d) float32 terms at most 256 MiB at a time (a long prefill)
    step = max(1, (1 << 28) // (rows.shape[1] * d * 4))
    parts = [(y[r] * w_).sum(1) for r, w_ in zip(rows.split(step),
                                                 w.split(step))]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def moe_ffn(x, params: Dict, cfg) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  params: router (d, E), w1/w3 (E, d, f),
    w2 (E, f, d).  Without a mesh all ``B * S`` tokens route together and
    the capacity counts them all; under one, see the module docstring."""
    with span("moe.ffn"):
        b, s, d = x.shape
        e = cfg.n_experts
        k = cfg.top_k
        xf = x.reshape(b * s, d)
        with span("moe.route"):
            top_w, top_ids = router_top_k(xf, params["router"], k)
        mesh = dctx.current_mesh()
        tp_ax = dctx.mesh_axes(mesh)[1] if mesh is not None else None
        # ZeRO-3 expert weights keep the expert-parallel path even at
        # model 1, as the reference's shard_map branch does
        zero3 = (mesh is not None and cfg.moe_fsdp_gather
                 and "data" in mesh.axis_names and mesh.shape["data"] > 1)
        if mesh is None or tp_ax is None or (mesh.shape[tp_ax] == 1
                                             and not zero3):
            cap = expert_capacity(b * s, k, cfg.capacity_factor, e)
            with span("moe.experts"):
                out = _local_moe(xf, top_ids, top_w, params["w1"],
                                 params["w2"], params.get("w3"),
                                 capacity=cap, act_name=cfg.activation)
            return out.to(x.dtype).reshape(b, s, d)

        if "w3" not in params:
            raise ValueError("MoE experts are gated (SwiGLU) in all "
                             "configs")
        if e % mesh.shape[tp_ax]:
            raise ValueError(f"{e} experts do not split over {tp_ax} = "
                             f"{mesh.shape[tp_ax]} ranks")
        if isinstance(params, Gathered) and params.row_axes:
            # the sharded trainer's local batch: these rows are this rank's
            # block of the tokens already
            dp, dp_size = (), 1
        else:
            dp = dctx.mesh_axes(mesh)[0]
            dp_size = mesh.axis_size(dp) if dp else 1
            if (b * s) % dp_size:
                # batch-1 decode: every data rank routes all
                dp, dp_size = (), 1
        t_loc = (b * s) // dp_size
        e_loc = e // mesh.shape[tp_ax]
        e_base = mesh.index(tp_ax) * e_loc
        rows = (slice(mesh.index(dp) * t_loc, (mesh.index(dp) + 1) * t_loc)
                if dp else slice(None))
        if zero3 and isinstance(params, Gathered):
            w1, w2, w3 = (gather_experts(params.shard(n), params.spec(n),
                                         mesh, e_loc, tp_ax)
                          for n in ("w1", "w2", "w3"))
        else:
            experts = slice(e_base, e_base + e_loc)
            w1, w2, w3 = (params[n][experts] for n in ("w1", "w2", "w3"))
        with span("moe.experts"):
            part = _local_moe(xf[rows], top_ids[rows], top_w[rows], w1, w2,
                              w3, capacity=expert_capacity(
                                  t_loc, k, cfg.capacity_factor, e),
                              act_name=cfg.activation, e_base=e_base)
        # the sum over the model group in the compute dtype, as the
        # reference's psum (the float32 accumulation inside _local_moe took
        # the long sums)
        out = psum(part.to(x.dtype), tp_ax, mesh)
        if dp:
            out = gather_rows(out, dp, mesh)
        return out.reshape(b, s, d)
