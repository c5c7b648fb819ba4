"""Plain mirror of the segmented scans of K1 ``ss2d_scan``, K8 ``ss2d_scan_bwd``
and K14 ``linear_scan``.

The kernels (``csrc/ss2d.cu``, ``csrc/ss2d_bwd.cu``) cut each direction's L
steps into segments that run at once and join them by a carry pass.  The
functions here are that decomposition in plain PyTorch, step by step as
the kernels take it, so that the algebra can be held against the
sequential plain versions of ``ops/fused_ss2d.py`` (and the JAX kernels) on
the CPU, and so that a card run can build the same decomposition with a
piece left out.

Forward, per (b, k, d), with la_t = delta_t A and b_t = delta_t B_t u_t:
h_t = exp(la_t) h_{t-1} + b_t.

1. :func:`scan_summaries`: each segment from h = 0: its end state and its
   decay, the sum of la over the segment;
2. :func:`carry_in`: the state entering each segment, one FMA per segment;
3. :func:`scan_from`: each segment again from its entry state.

Adjoint, with c_t = g_t C_t: lam_t = c_t + exp(la_{t+1}) lam_{t+1}, run
backwards.  What flows into segment s - 1 from segment s is E = a lam at
segment s's first step.

1. :func:`adjoint_summaries`: each segment from lam = 0 past its end: the
   E it passes on and its decay;
2. :func:`carry_back`: the E entering each segment from the later ones;
3. :func:`adjoint_from`: each segment again from its E.

Everything is fp32; a bf16 ``x`` or ``g_y`` is read as its rounded values,
as the kernels read it.  ``seg`` is the segment length in steps (the
kernels' :func:`~tramba_tpu_torch.ops.fused_ss2d.scan_segment_steps`; any
length here), ``chunk`` the carries' stride.

K14 (``csrc/scan.cu``) runs h_t = a_t h_{t-1} + b_t in one pass
(or, on its column route, one thread a column: ``seg`` = L, ``parts`` = 1):
:func:`linear_scan_plan` is its plan (``linear_scan_plan`` of the library,
reported by ``selective_scan.linear_scan_plan``), and
:func:`linear_scan_segmented` its decomposition: segments of the plan's
length, each cut into eight walkers' parts run from a zero state (local
state and running product of a), the parts' summaries joined into the
segment's, the carry entering each segment from the earlier segments'
summaries (the look-back), then h = local state + running product x the
state entering the part.  It takes ``fault``, a named mistake planted in
it (:data:`LINEAR_SCAN_FAULTS`), so that a check can show it would see a
kernel making it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tramba_tpu_torch.ops.fused_ss2d import (SCAN_CHUNK, _decay_terms, _in_scan_order,
                                             _merge_sum)

__all__ = ["scan_terms", "scan_summaries", "carry_in", "scan_from", "scan_outputs",
           "ss2d_scan_segmented", "adjoint_terms", "adjoint_summaries", "carry_back",
           "adjoint_from", "adjoint_outputs", "ss2d_scan_bwd_segmented", "LINEAR_SCAN_FAULTS",
           "linear_scan_faults", "linear_scan_plan", "linear_scan_segmented"]


def _split(t, seg):
    """(B, K, L, D) -> (B, K, S, seg, D), zero past L: a padded step has
    la = 0 and b = c = 0, which leaves a state as it is."""
    B, K, L, D = t.shape
    S = -(-L // seg)
    return F.pad(t, (0, 0, 0, S * seg - L)).reshape(B, K, S, seg, D)


def _join(t, L):
    """(B, K, S, seg, D) -> (B, K, L, D)."""
    B, K, S, seg, D = t.shape
    return t.reshape(B, K, S * seg, D)[:, :, :L]


def scan_terms(x, idx, x_proj_w, dt_w, dt_b, A_logs, Ds):
    """The per-step terms of K1 in scan order: (la, b, xs, dbcs, dbc), la and
    b (B, K, L, D) as above, xs (B, K, L, D) and dbcs (B, K, L, R+2) the
    inputs at step t of direction k, dbc (B, L, K, R+2) the projections."""
    dbc = torch.einsum("bld,kcd->blkc", x.float(), x_proj_w.float())
    xs, dbcs = _in_scan_order(x, idx, dbc)
    R = dt_w.shape[-1]
    _, delta, _, A = _decay_terms(dbcs, dt_w, dt_b, A_logs)
    return delta * A, delta * dbcs[..., R:R + 1] * xs, xs, dbcs, dbc


def scan_summaries(la, b, seg):
    """Each segment's end state from h = 0 and its decay sum: two (B, K, S, D)."""
    las, bs = _split(la, seg), _split(b, seg)
    h = torch.zeros_like(las[:, :, :, 0])
    for j in range(seg):
        h = torch.exp(las[:, :, :, j]) * h + bs[:, :, :, j]
    return h, las.sum(3)


def carry_in(h_end, la_sum):
    """The state entering each segment (B, K, S, D): 0 for the first, then
    exp(la_sum[s]) entry[s] + h_end[s], segment by segment."""
    entries = [torch.zeros_like(h_end[:, :, 0])]
    for s in range(h_end.shape[2] - 1):
        entries.append(torch.exp(la_sum[:, :, s]) * entries[-1] + h_end[:, :, s])
    return torch.stack(entries, dim=2)


def scan_from(la, b, entries, seg):
    """Each segment run from its entry state: the states h (B, K, L, D)."""
    las, bs = _split(la, seg), _split(b, seg)
    h, out = entries, []
    for j in range(seg):
        h = torch.exp(las[:, :, :, j]) * h + bs[:, :, :, j]
        out.append(h)
    return _join(torch.stack(out, dim=3), la.shape[2])


def scan_outputs(h, xs, dbcs, Ds, chunk=SCAN_CHUNK):
    """K1's outputs from the states: (ys (B, K, L, D), carries (B, K,
    ceil(L / chunk), D)), the state entering each chunk."""
    K, L = h.shape[1], h.shape[2]
    starts = torch.arange(0, L, chunk, device=h.device)
    carries = torch.cat([torch.zeros_like(h[:, :, :1]), h[:, :, starts[1:] - 1]], dim=2)
    ys = h * dbcs[..., -1:] + xs * Ds.float().reshape(K, 1, -1)
    return ys, carries


def ss2d_scan_segmented(x, idx, x_proj_w, dt_w, dt_b, A_logs, Ds, seg, chunk=SCAN_CHUNK):
    """K1's train variant by segments: (ys, carries, dbc) as
    ``ss2d_scan_train_ref`` returns them."""
    la, b, xs, dbcs, dbc = scan_terms(x, idx, x_proj_w, dt_w, dt_b, A_logs, Ds)
    h = scan_from(la, b, carry_in(*scan_summaries(la, b, seg)), seg)
    return (*scan_outputs(h, xs, dbcs, Ds, chunk), dbc)


def adjoint_terms(x, idx, g_y, dbc, dt_w, dt_b, A_logs):
    """The per-step terms of K8's adjoint: (la, c, g, xs, dbcs, v, delta, A):
    la = delta A and c = g C (B, K, L, D), g the cotangent gathered in scan
    order, the inputs in scan order and the decay terms of ``_decay_terms``."""
    R = dt_w.shape[-1]
    xs, dbcs = _in_scan_order(x, idx, dbc.float())
    g = g_y.float()[:, idx.long()]  # the merge's adjoint: a gather
    v, delta, _, A = _decay_terms(dbcs, dt_w, dt_b, A_logs)
    return delta * A, g * dbcs[..., R + 1:R + 2], g, xs, dbcs, v, delta, A


def adjoint_summaries(la, c, seg):
    """Each segment from lam = 0 past its last step, down to its first step
    t_s: (E, la_sum), E = a_{t_s} lam_{t_s} what it passes to the segment
    before it, la_sum its decay sum; two (B, K, S, D)."""
    las, cs = _split(la, seg), _split(c, seg)
    lam = a_next = torch.zeros_like(las[:, :, :, 0])
    for j in range(seg - 1, -1, -1):
        lam = a_next * lam + cs[:, :, :, j]
        a_next = torch.exp(las[:, :, :, j])
    return a_next * lam, las.sum(3)


def carry_back(E, la_sum):
    """The E entering each segment's last step from the segments after it
    (B, K, S, D): 0 for the last, then exp(la_sum[s]) E_in[s] + E[s] for
    segment s - 1, segment by segment backwards."""
    S = E.shape[2]
    entries = [torch.zeros_like(E[:, :, 0])]
    for s in range(S - 1, 0, -1):
        entries.append(torch.exp(la_sum[:, :, s]) * entries[-1] + E[:, :, s])
    return torch.stack(entries[::-1], dim=2)


def adjoint_from(la, c, E_in, seg):
    """Each segment's lam run back from the E entering it: lam (B, K, L, D)."""
    las, cs = _split(la, seg), _split(c, seg)
    lam, a_next, out = E_in, torch.ones_like(E_in), [None] * seg
    for j in range(seg - 1, -1, -1):
        lam = a_next * lam + cs[:, :, :, j]
        a_next = torch.exp(las[:, :, :, j])
        out[j] = lam
    return _join(torch.stack(out, dim=3), la.shape[2])


def adjoint_outputs(lam, terms, inv, carries, x_dtype, x_proj_w, dt_w, Ds, chunk=SCAN_CHUNK):
    """K8's outputs from lam and :func:`adjoint_terms`: the states of each
    chunk recomputed from its carry, then the same tuple as
    ``ss2d_scan_bwd_ref`` (dx (B, L, D) in ``x_dtype``, dwx, dwdt, dbias,
    dA_logs, dDs)."""
    la, _, g, xs, dbcs, v, delta, A = terms
    R = dt_w.shape[-1]
    K, L = la.shape[1], la.shape[2]
    Bc = dbcs[..., R:R + 1]
    a = torch.exp(la)
    b_in = delta * Bc * xs
    # every chunk at once from its carry, its steps in order (padded steps
    # past L: a = 1, b = 0)
    ac, bc = _split(a - 1, chunk) + 1, _split(b_in, chunk)
    h, prev = carries.float(), []
    for j in range(chunk):
        prev.append(h)
        h = ac[:, :, :, j] * h + bc[:, :, :, j]
    h_prev = _join(torch.stack(prev, dim=3), L)
    hs = a * h_prev + b_in
    daA = lam * h_prev * a
    ddt = (daA * A + lam * xs * Bc) * torch.sigmoid(v)
    d_dbc = torch.cat([torch.einsum("bkld,kdr->bklr", ddt, dt_w.float()),
                       (lam * delta * xs).sum(-1, keepdim=True),
                       (g * hs).sum(-1, keepdim=True)], dim=-1)
    du = lam * delta * Bc + g * Ds.float().reshape(K, 1, -1)
    du = du + torch.einsum("bklc,kcd->bkld", d_dbc, x_proj_w.float())
    dx = _merge_sum(du, inv)
    dwx = torch.einsum("bklc,bkld->kcd", d_dbc, xs)
    dwdt = torch.einsum("bkld,bklr->kdr", ddt, dbcs[..., :R])
    dA = (daA * delta).sum((0, 2))
    return (dx.to(x_dtype), dwx, dwdt, ddt.sum((0, 2)), dA * A[:, 0], (g * xs).sum((0, 2)))


def ss2d_scan_bwd_segmented(x, idx, inv, g_y, carries, dbc, x_proj_w, dt_w, dt_b, A_logs, Ds,
                            seg, chunk=SCAN_CHUNK):
    """K8 by segments: the same tuple as ``ss2d_scan_bwd_ref``."""
    terms = adjoint_terms(x, idx, g_y, dbc, dt_w, dt_b, A_logs)
    la, c = terms[0], terms[1]
    lam = adjoint_from(la, c, carry_back(*adjoint_summaries(la, c, seg)), seg)
    return adjoint_outputs(lam, terms, inv, carries, x.dtype, x_proj_w, dt_w, Ds, chunk)


# K14's tiling (csrc/scan.cu): most rows a segment, channels a block,
# walkers a channel; from COLUMNS_MIN columns (R C) one thread a column,
# COLUMN_THREADS columns a block
SCAN_SEG, SCAN_CHANNELS, SCAN_PARTS = 256, 32, 8
COLUMNS_MIN, COLUMN_THREADS = 16384, 128
# "carry dropped between segments": every segment starts from h = 0; "prod a
# over the whole segment": the carry is scaled by the product of a over the
# walker's whole share of the segment instead of up to row t
LINEAR_SCAN_FAULTS = ("carry dropped between segments", "prod a over the whole segment")


def linear_scan_plan(R: int, L: int, C: int) -> dict:
    """``linear_scan_plan`` of ``csrc/scan.cu`` for (R, L, C) tensors: {"route",
    "seg", "segments", "channels", "parts", "blocks", "smem"}
    (``selective_scan.SCAN_PLAN_FIELDS``): segments of up to 256 rows, or,
    from :data:`COLUMNS_MIN` columns, one thread a column (route 1: one
    segment of L rows, one walker).  Raises where K14 has no plan."""
    if min(R, L, C) < 1:
        raise ValueError(f"linear_scan: no plan for R={R}, L={L}, C={C}")
    if R * C >= COLUMNS_MIN:
        route, seg, channels, parts, smem = 1, L, COLUMN_THREADS, 1, 0
    else:
        route, seg, channels, parts = 0, min(L, SCAN_SEG), SCAN_CHANNELS, SCAN_PARTS
        smem = 2 * seg * SCAN_CHANNELS * 4
    segments = -(-L // seg)
    blocks = R * -(-C // channels) * segments
    if blocks > 2 ** 31 - 1:
        raise ValueError(f"linear_scan: R={R}, L={L}, C={C} makes more than 2^31 blocks")
    return dict(route=route, seg=seg, segments=segments, channels=channels, parts=parts,
                blocks=blocks, smem=smem)


def linear_scan_faults(L: int, seg: int = None, parts: int = SCAN_PARTS) -> tuple:
    """The faults of :data:`LINEAR_SCAN_FAULTS` that bear on L steps in
    segments of ``seg`` (the plan's by default) over ``parts`` walkers: the
    carry between segments where there are two, the running product where a
    walker holds more than one row and enters with a carry."""
    seg = seg or min(L, SCAN_SEG)
    rows = -(-min(L, seg) // parts)  # rows a walker
    bears = {"carry dropped between segments": L > seg,
             "prod a over the whole segment": rows > 1 and (parts > 1 or L > seg)}
    return tuple(f for f in LINEAR_SCAN_FAULTS if bears[f])


def linear_scan_segmented(a, b, reverse=False, seg=None, parts=SCAN_PARTS, fault=None):
    """K14's decomposition of h over axis -2 of (..., L, C) tensors (``reverse``:
    from the last row back), in fp32; ``seg`` the segment length (the
    plan's by default).  Returns h (..., L, C)."""
    if fault is not None and fault not in LINEAR_SCAN_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    shape = a.shape
    L, C = shape[-2], shape[-1]
    seg = seg or min(L, SCAN_SEG)
    a3, b3 = a.float().reshape(-1, L, C), b.float().reshape(-1, L, C)
    if reverse:  # logical step t is row L - 1 - t
        a3, b3 = a3.flip(1), b3.flip(1)
    out, carry = [], torch.zeros_like(a3[:, 0])
    for t0 in range(0, L, seg):
        n = min(seg, L - t0)
        rp = -(-n // parts)
        pad = parts * rp - n  # padded steps: a = 1, b = 0 leave a state as it is
        sa = F.pad(a3[:, t0:t0 + n], (0, 0, 0, pad), value=1.0).reshape(-1, parts, rp, C)
        sb = F.pad(b3[:, t0:t0 + n], (0, 0, 0, pad)).reshape(-1, parts, rp, C)
        st, pa = torch.zeros_like(sa[:, :, 0]), torch.ones_like(sa[:, :, 0])
        local, prod = [], []
        for i in range(rp):  # every walker's rows from a zero state
            st = sa[:, :, i] * st + sb[:, :, i]
            pa = pa * sa[:, :, i]
            local.append(st)
            prod.append(pa)
        local, prod = torch.stack(local, 2), torch.stack(prod, 2)
        if fault == "prod a over the whole segment":
            prod = pa[:, :, None].expand_as(prod)
        entry = carry if fault != "carry dropped between segments" else torch.zeros_like(carry)
        entries = []
        for p in range(parts):  # the state entering each part, then the segment's end
            entries.append(entry)
            entry = pa[:, p] * entry + st[:, p]
        h = local + prod * torch.stack(entries, 1)[:, :, None]
        out.append(h.reshape(-1, parts * rp, C)[:, :n])
        carry = entry
    h = torch.cat(out, 1)
    return (h.flip(1) if reverse else h).reshape(shape)
