"""Plain PyTorch window scan: the C3 iteration kernel's oracle.

A transcription of ``repro.core.jax_engine._iteration_scan`` (with the trace
reassembly of ``_group_iteration`` and the summary of ``_group_summary``): a
Python loop over the workload's static step table, each step a few
elementwise operations on (lanes,) float64 tensors.  Lanes are grouped G at a
time (one barrier group, a node's devices); group b holds lanes
[b G, (b + 1) G).

Inputs (all float64 but the table):

  table   (n_steps, 3) int32: (kind, kernel or comm index, capped) per step,
          kinds ``KERNEL`` / ``COMM`` / ``PULL``
  rate_f, rate_f_s  (L,) GFLOP/s per lane at full rate and slowed by the
          comm's contention (rate_f / (1 + kappa_comp))
  rm, rm_s  (B,) HBM GB/s per group, B = L / G, full and slowed
  noise   (S, Kc, P) per-kernel noise factor, L = S P: sample s holds lanes
          [s P, (s + 1) P), and kernel i of lane s P + p is noise[s, i, p]
  gflop, gbyte  (Kc,) the workload's kernel tables
  dur     (B, Km) collective durations per group

Each arithmetic step keeps ``_iteration_scan``'s operations and their order,
so the CUDA kernel (``csrc/c3_window.cu``), which rounds each operation on
its own, gives the same bits.

``c3_window_draw_ref`` is the plain version of the kernel's draw form: it
draws the noise of ``_fleet_scan_core``'s ``draw_noise``
(``repro/core/jax_engine.py:573-585``) from JAX's streams with
``repro_torch.core.prng`` and runs ``c3_window_ref`` on it, in summary mode.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng

KERNEL, COMM, PULL = 0, 1, 2     # step kinds of the table (jax_engine's)


def c3_window_ref(table: torch.Tensor, rate_f: torch.Tensor,
                  rate_f_s: torch.Tensor, rm: torch.Tensor,
                  rm_s: torch.Tensor, noise: torch.Tensor,
                  gflop: torch.Tensor, gbyte: torch.Tensor,
                  dur: torch.Tensor, G: int, emit: bool):
    """One iteration of every group.  ``emit``: the full trace
    ``(comp_start, comp_end, comp_ovl, comm_lstart, comm_gend, busy)``, the
    first three (Kc, L), ``comm_lstart`` (Km, L), ``comm_gend`` (B, Km),
    ``busy`` (L,), never-reached starts and ends NaN; else the summary
    ``(t_iter (B,), util (L,))``."""
    L = rate_f.numel()
    B = L // G
    S, Kc, P = noise.shape
    Km = dur.shape[1]
    dev, f64 = rate_f.device, torch.float64
    nz = noise.permute(1, 0, 2).reshape(Kc, L)       # (Kc, L)
    rm_l, rm_s = rm.repeat_interleave(G), rm_s.repeat_interleave(G)

    t = torch.zeros(L, dtype=f64, device=dev)
    ci = torch.zeros(L, dtype=torch.int64, device=dev)
    started = torch.zeros(L, dtype=torch.bool, device=dev)
    gfr, gbr, busy, cur_start = (torch.zeros(L, dtype=f64, device=dev)
                                 for _ in range(4))
    prev_end = torch.zeros(B, dtype=f64, device=dev)
    if emit:
        comp_start = torch.full((Kc, L), float("nan"), dtype=f64, device=dev)
        comp_end = torch.full((Kc, L), float("nan"), dtype=f64, device=dev)
        comp_ovl = torch.zeros((Kc, L), dtype=f64, device=dev)
        comm_lstart = torch.empty((Km, L), dtype=f64, device=dev)
        comm_gend = torch.empty((B, Km), dtype=f64, device=dev)

    for kind, i, cap in table.tolist():
        if kind == KERNEL:
            ts = prev_end.repeat_interleave(G) if cap else float("inf")
            rf, rmm = (rate_f_s, rm_s) if cap else (rate_f, rm_l)
            m = ci == i
            ns = m & ~started
            cur_start = torch.where(ns, t, cur_start)
            gfr = torch.where(ns, gflop[i] * nz[i], gfr)
            gbr = torch.where(ns, gbyte[i] * nz[i], gbr)
            started = started | ns
            dt = gfr / rf + gbr / rmm
            fits = m & (t + dt <= ts)
            t = torch.where(fits, t + dt, t)
            busy = torch.where(fits, busy + (t - cur_start), busy)
            started = started & ~fits
            ci = torch.where(fits, i + 1, ci)
            if emit:
                comp_start[i] = torch.where(ns, cur_start, comp_start[i])
                comp_end[i] = torch.where(fits, t, comp_end[i])
            if cap:      # a window step: partial progress up to the barrier
                avail = ts - t
                pp = m & ~fits & (avail > 0)
                use = torch.minimum(avail, gfr / rate_f_s)
                gbr = torch.where(
                    pp, torch.clamp_min(gbr - (avail - use) * rm_s, 0.0), gbr)
                gfr = torch.where(pp, gfr - use * rate_f_s, gfr)
                if emit:         # the time this step overlapped the comm
                    comp_ovl[i] = comp_ovl[i] + (
                        torch.where(fits, dt, 0.0) + torch.where(pp, avail, 0.0))
        elif kind == COMM:
            if emit:
                comm_lstart[i] = t
            prev_end = t.view(B, G).amax(1) + dur[:, i]
            if emit:
                comm_gend[:, i] = prev_end
        else:
            t = prev_end.repeat_interleave(G)
    if emit:
        return comp_start, comp_end, comp_ovl, comm_lstart, comm_gend, busy
    t_iter = torch.maximum(t.view(B, G).amax(1), prev_end)
    return t_iter, busy / torch.clamp_min(t_iter, 1e-12).repeat_interleave(G)


def c3_window_draw_ref(table: torch.Tensor, rate_f: torch.Tensor,
                       rate_f_s: torch.Tensor, rm: torch.Tensor,
                       rm_s: torch.Tensor, keys: torch.Tensor, datum: int,
                       sigma: torch.Tensor, base: torch.Tensor,
                       spike_p: torch.Tensor, spike_mult: torch.Tensor,
                       spike: bool, gflop: torch.Tensor, gbyte: torch.Tensor,
                       G: int):
    """One iteration of every group in summary mode, ``(t_iter, util)``,
    with the noise JAX's fleet scan draws for sample s from
    ``fold_in(keys[s], datum)``: split in k1, k2, k3; the kernel factors
    exp(sigma z) of ``normal(k1, (N, G, Kc))``; the durations
    base x exp(sigma z) of ``normal(k2, (N, Km))``, under ``spike`` times
    mult (1 + u) where ``uniform(ks, (N, Km)) < p``, with ks, ku = split(k3)
    and u = ``uniform(ku, (N, Km))``.

    ``keys`` (S, 2) raw keys; ``sigma``, ``spike_p``, ``spike_mult`` (S,);
    ``base`` (S, Km) the collectives' base durations; the other inputs as
    ``c3_window_ref``'s, sample s holding lanes [s P, (s + 1) P), P = L / S,
    of N = P / G nodes."""
    S, L, Kc = keys.shape[0], rate_f.numel(), gflop.numel()
    P, Km = L // S, base.shape[1]
    N = P // G
    k = prng.split(prng.fold_in(keys, datum), 3)
    sig = sigma.view(S, 1, 1)
    noise = torch.exp(sig * prng.normal(k[:, 0], (P, Kc)))    # (S, P, Kc)
    dur = base.view(S, 1, Km) * torch.exp(sig * prng.normal(k[:, 1],
                                                             (N, Km)))
    if spike:
        ks, ku = prng.split(k[:, 2], 2).unbind(1)
        hit = prng.uniform(ks, (N, Km)) < spike_p.view(S, 1, 1)
        mult = spike_mult.view(S, 1, 1) * (1.0 + prng.uniform(ku, (N, Km)))
        dur = dur * torch.where(hit, mult, 1.0)
    return c3_window_ref(table, rate_f, rate_f_s, rm, rm_s,
                         noise.transpose(1, 2), gflop, gbyte,
                         dur.reshape(S * N, Km), G, emit=False)


def jax_normal_ref(keys: torch.Tensor, datum: int, M: int) -> torch.Tensor:
    """(S, M) float64: ``jax.random.normal(fold_in(keys[s], datum), (M,))``,
    the plain version of the ``jax_normal`` kernel."""
    return prng.normal(prng.fold_in(keys, datum), (M,))
