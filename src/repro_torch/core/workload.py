"""Iteration workload builder: the FSDP kernel schedule of Figure 2.

Produces the per-iteration kernel lists the C3 simulator executes:
  * compute stream — ordered compute kernels (GFLOP or GB of work), each
    optionally gated on a communication kernel's completion;
  * comm stream — ordered collectives (bytes), each optionally gated on a
    producer compute kernel.
Forward: AG(l) gates layer-l compute; AG(l+1) streams behind it (overlap
window = qkv_ip .. attn_op, emergent).  Backward: RS(l) waits on b_mlp_dp(l)
then AG(l-1) queues immediately after — exactly Fig 2.  MoE mode adds
non-overlapped all-to-alls that gate the next compute kernel (paper §VII-C:
per-layer sync, small leads + spikes).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.configs.base import ModelConfig


@dataclass
class CompKernel:
    name: str
    gflop: float = 0.0                 # compute-bound work (scales with f)
    gbyte: float = 0.0                 # memory-bound work (f-independent)
    wait_comm: Optional[int] = None    # comm index that must finish first


@dataclass
class CommKernel:
    name: str
    bytes: float                       # payload per device
    producer: Optional[int] = None     # compute index that must finish first
    blocking: bool = False             # MoE a2a: consumer compute waits on it


@dataclass
class Workload:
    comp: List[CompKernel]
    comm: List[CommKernel]
    name: str = ""
    act_bytes: float = 0.0             # per-boundary activation payload —
    #                                    the PP point-to-point / TP per-sync
    #                                    link-model default (topology.py)
    n_layers: int = 0                  # layers represented; TP defaults to
    #                                    2 sync points per layer (AG + RS)

    @property
    def total_gflop(self) -> float:
        return sum(k.gflop for k in self.comp)

    @property
    def total_bytes(self) -> float:
        return sum(k.bytes for k in self.comm)


def fsdp_llm_iteration(cfg: ModelConfig, *, batch: int = 2,
                       seq: int = 4096, n_shards: int = 8,
                       dtype_bytes: int = 2) -> Workload:
    """One training iteration of ``cfg`` under FSDP across ``n_shards``."""
    T = batch * seq
    d, dff = cfg.d_model, cfg.d_ff
    qd, kvd = cfg.q_dim, cfg.kv_dim
    L = cfg.n_layers
    moe = cfg.moe is not None
    layer_bytes = cfg.layer_params(max(cfg.moe.first_k_dense if moe else 0,
                                       0)) * dtype_bytes
    ag_bytes = layer_bytes * (n_shards - 1) / n_shards
    rs_bytes = ag_bytes                       # grads, same payload

    comp: List[CompKernel] = []
    comm: List[CommKernel] = []

    def gemm_flops_fwd():
        """Per-layer forward GEMM+attention GFLOPs (split per Fig 2 names)."""
        eff_s = min(seq, cfg.window) if cfg.window else seq
        fa = 2 * 2 * T * eff_s * d / 2 / 1e9          # causal flash attention
        out = {
            "attn_n": 0.0,                            # vec kernel: bytes only
            "qkv_ip": 2 * T * d * (qd + 2 * kvd) / 1e9,
            "attn_fa": fa,
            "attn_op": 2 * T * qd * d / 1e9,
            "mlp_n": 0.0,
            "mlp_gp": 2 * T * d * dff / 1e9,
            "mlp_up": 2 * T * d * dff / 1e9 if cfg.gated_mlp else 0.0,
            "mlp_dp": 2 * T * dff * d / 1e9,
        }
        if moe:
            m = cfg.moe
            act = (m.top_k + m.n_shared)
            e_flops = 2 * T * d * m.d_expert * act * (3 if cfg.gated_mlp
                                                      else 2) / 1e9
            out["mlp_gp"] = e_flops * 0.4
            out["mlp_up"] = e_flops * 0.3
            out["mlp_dp"] = e_flops * 0.3
        return out

    vec_gb = T * d * dtype_bytes * 4 / 1e9           # norm read+write x2

    fwd = gemm_flops_fwd()
    # ---------------- forward ------------------------------------------------
    for l in range(L):
        ag = len(comm)
        comm.append(CommKernel(f"ag_f{l}", ag_bytes))
        first = True
        for kname, gf in fwd.items():
            wait = ag if first else None
            first = False
            comp.append(CompKernel(f"f_{kname}", gflop=gf,
                                   gbyte=vec_gb if kname.endswith("_n")
                                   else 0.0, wait_comm=wait))
        if moe:
            # dispatch a2a after router (gates expert gemms), combine after
            disp = len(comm)
            a2a_bytes = T * d * dtype_bytes * (n_shards - 1) / n_shards
            # router ran inside mlp_n position; dispatch gates mlp_gp
            comm.append(CommKernel(f"a2a_fd{l}", a2a_bytes,
                                   producer=len(comp) - 4, blocking=True))
            comp[-3].wait_comm = disp            # expert gemm waits dispatch
            comb = len(comm)
            comm.append(CommKernel(f"a2a_fc{l}", a2a_bytes,
                                   producer=len(comp) - 1, blocking=True))
            comp.append(CompKernel(f"f_moe_comb{l}", gbyte=vec_gb / 2,
                                   wait_comm=comb))

    # ---------------- backward (reverse layer order) -------------------------
    for l in reversed(range(L)):
        ag = len(comm)
        comm.append(CommKernel(f"ag_b{l}", ag_bytes))
        first = True
        # backward ~2x forward flops, dp/up first then attention (Fig 2)
        order = list(fwd.items())[::-1]
        for kname, gf in order:
            wait = ag if first else None
            first = False
            comp.append(CompKernel(f"b_{kname}", gflop=2 * gf,
                                   gbyte=2 * vec_gb if kname.endswith("_n")
                                   else 0.0, wait_comm=wait))
        if moe:
            a2a_bytes = T * d * dtype_bytes * (n_shards - 1) / n_shards
            disp = len(comm)
            comm.append(CommKernel(f"a2a_bd{l}", a2a_bytes,
                                   producer=len(comp) - 8, blocking=True))
        rs = len(comm)
        comm.append(CommKernel(f"rs_b{l}", rs_bytes,
                               producer=len(comp) - 1))

    # optimizer step after the last reduce-scatter
    comp.append(CompKernel("opt_step", gbyte=3 * layer_bytes * L / n_shards
                           / 1e9, wait_comm=len(comm) - 1))
    return Workload(comp, comm, name=f"{cfg.name}-b{batch}s{seq // 1024}k",
                    act_bytes=float(T * d * dtype_bytes), n_layers=L)
