"""The windowed-aggregation engine (reference DESIGN.md §9).

Evaluates every window lane of one ``window_aggregate`` call over a table
already sorted by ``(partition_by, order_by)`` — the range layout the
range exchange establishes.  One pass, organized around the segment
machinery (``segments.py``):

  * **rolling** sum/mean/count/min/max (``rows=w``): all sum lanes ride ONE
    fused ``windowed_scan`` (mean = sum lane / count; count is index
    arithmetic off ``seg_start``), min/max scan one column each — the
    ``kernels/window_scan`` kernel on the card;
  * **cumulative** aggregates (``rows=None``): the same lanes through
    ``segmented_cumulative`` plus the cross-shard carry chain;
  * **lag / lead / row_number / rank**: gathers and index arithmetic off
    the same segment boundaries.

Cross-shard correctness rides a bounded ``ppermute`` halo (rolling, lag,
lead) and an all-gathered carry chain (cumulative, row_number, rank);
neither is an exchange and neither sorts, so a window on a range layout
adds zero ``array_ops.EXCHANGES`` and zero ``array_ops.SORTS``.

Overflow (DESIGN.md §2): a window is *truncated* when it needs rows from
beyond what the halo can prove (the predecessor shard held fewer
same-partition rows than the lookback; for lead, the successor's head ran
out while the partition could not be proven to end).  Truncated windows
are counted, never silently wrong: zero overflow certifies the result.

:func:`eval_window` takes one entry per shard this process holds — every
shard when they are virtual, the rank's own on a process group
(``core/context.py``) — and runs each phase over them around the
collectives; the pooled summaries are indexed by global shard id.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.array_ops import shard_span, spmd_allgather
from ..core.exchange import order_lanes
from ..core.table_ops import _bcast
from ..kernels.window_scan import ops as wops
from ..kernels.window_scan.ref import _combine
from .segments import (boundary_flags, chain_carries, flag_starts, head_halo,
                       tail_halo)

Cols = Dict[str, torch.Tensor]

#: op → (needs a value column, takes an offset param)
WINDOW_OPS = {
    "sum": (True, False), "mean": (True, False), "count": (False, False),
    "min": (True, False), "max": (True, False),
    "lag": (True, True), "lead": (True, True),
    "row_number": (False, False), "rank": (False, False),
}


def normalize_aggs(aggs, columns: Sequence[str], rows: Optional[int]
                   ) -> List[Tuple[str, Optional[str], str, int]]:
    """Validate window specs eagerly; returns ``(label, col, op, param)``.

    Accepts ``(col, op)`` and ``(col, op, offset)`` entries; ``col`` is
    ``None`` for row_number/rank.  Errors name the offending entry.
    """
    out = []
    seen = set(columns)
    if rows is not None and (not isinstance(rows, int) or rows < 1):
        raise ValueError(f"rows={rows!r} must be a positive int or None "
                         f"(cumulative)")
    if not aggs:
        raise ValueError("window aggregation needs at least one agg")
    for entry in aggs:
        if len(entry) == 2:
            col, op = entry
            param = 1
        elif len(entry) == 3:
            col, op, param = entry
        else:
            raise ValueError(f"window agg {entry!r} must be (col, op) or "
                             f"(col, op, offset)")
        if op not in WINDOW_OPS:
            raise ValueError(f"unknown window op {op!r} in {entry!r}; "
                             f"expected one of {tuple(WINDOW_OPS)}")
        needs_col, takes_param = WINDOW_OPS[op]
        if needs_col or (op == "count" and col is not None):
            if col not in columns:
                raise ValueError(f"window agg {entry!r} names unknown "
                                 f"column {col!r}")
        elif col is not None:
            raise ValueError(f"window op {op!r} takes no column; use "
                             f"(None, {op!r})")
        if takes_param:
            if not isinstance(param, int) or param < 1:
                raise ValueError(f"window agg {entry!r}: offset must be a "
                                 f"positive int, got {param!r}")
        elif len(entry) == 3:
            raise ValueError(f"window op {op!r} takes no offset "
                             f"({entry!r})")
        if op in ("row_number", "rank") or (op == "count" and col is None):
            label = op
        elif takes_param and param != 1:
            label = f"{col}_{op}{param}"
        else:
            label = f"{col}_{op}"
        if label in seen:
            raise ValueError(f"window output column {label!r} collides "
                             f"with an existing column or another agg")
        seen.add(label)
        out.append((label, col, op, param))
    return out


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def eval_window(cols: Sequence[Cols], counts: Sequence[torch.Tensor], *,
                pkeys, okeys, ascending, aggs, rows: Optional[int],
                n_shards: int, group=None
                ) -> Tuple[List[Cols], List[torch.Tensor]]:
    """Evaluate normalized window ``aggs`` over sorted shard columns.

    ``cols[s]``/``counts[s]`` are shard ``s``'s columns and valid-row
    count.  Returns ``(new columns, overflow)``, one entry per shard;
    input columns are untouched (a window never moves or drops rows).
    """
    p = len(cols)
    first = shard_span(cols, group)[1]  # global id of local shard 0
    cap = next(iter(cols[0].values())).shape[0]
    dev = counts[0].device
    idx = torch.arange(cap, device=dev)
    distributed = n_shards > 1

    sum_cols = list(dict.fromkeys(
        c for _, c, op, _ in aggs if op in ("sum", "mean")))
    mm_items = list(dict.fromkeys(
        (c, op) for _, c, op, _ in aggs if op in ("min", "max")))
    lags = [(lb, c, k) for lb, c, op, k in aggs if op == "lag"]
    leads = [(lb, c, k) for lb, c, op, k in aggs if op == "lead"]
    need_rank = any(op == "rank" for _, _, op, _ in aggs)
    need_rn = any(op == "row_number" for _, _, op, _ in aggs)
    rolling = rows is not None
    n_sum = len(sum_cols)

    # ---- per-shard segment state -----------------------------------------
    st = []
    for c, count in zip(cols, counts):
        mask = idx < count
        lanes = order_lanes(c, tuple(pkeys) + tuple(okeys), ascending)
        plane = lanes[:, :len(pkeys)]
        seg_start = flag_starts(boundary_flags(plane, mask))
        # f32 scan lanes: sum columns first, then one per min/max column
        parts = [c[k].to(torch.float32)[:, None] for k in sum_cols]
        parts += [c[k].to(torch.float32)[:, None] for k, _ in mm_items]
        st.append({
            "count": count, "mask": mask, "lanes": lanes, "plane": plane,
            "seg_start": seg_start,
            "run_start": (flag_starts(boundary_flags(lanes, mask))
                          if need_rank else None),
            "scan": (torch.cat(parts, dim=1) if parts else
                     torch.zeros((cap, 0), dtype=torch.float32, device=dev)),
            "last": torch.clamp(count - 1, 0, cap - 1),
            "nonempty": count > 0,
            "carry_cnt": torch.zeros((), dtype=torch.int64, device=dev),
            "carry_run": torch.zeros((), dtype=torch.int64, device=dev),
        })

    # ---- cross-shard carry chain (unbounded lookback) ---------------------
    if distributed:
        def pool(fn):  # per-shard summary → the (n_shards, ...) pool
            return spmd_allgather([fn(x) for x in st], tiled=False,
                                  group=group)[0]

        head_k = pool(lambda x: x["plane"][0])
        tail_k = pool(lambda x: x["plane"][x["last"]])
        whole = pool(lambda x: x["nonempty"]
                     & (x["seg_start"][x["last"]] == 0))
        ne = pool(lambda x: x["nonempty"])
        cc = chain_carries(head_k, tail_k, pool(
            lambda x: torch.where(x["nonempty"],
                                  x["last"] - x["seg_start"][x["last"]] + 1,
                                  0)), whole, ne)
        cr = chain_carries(
            pool(lambda x: x["lanes"][0]),
            pool(lambda x: x["lanes"][x["last"]]),
            pool(lambda x: torch.where(
                x["nonempty"], x["last"] - x["run_start"][x["last"]] + 1,
                0)),
            pool(lambda x: x["nonempty"]
                 & (x["run_start"][x["last"]] == 0)), ne) \
            if need_rank else None
        for s, x in enumerate(st):
            x["carry_cnt"] = cc[first + s]
            if need_rank:
                x["carry_run"] = cr[first + s]

    out: List[Cols] = [{} for _ in range(p)]
    overflow = [torch.zeros((), dtype=torch.int32, device=dev)
                for _ in range(p)]

    # ---- backward halo: rolling scans AND lag share one ppermute ----------
    h_roll = rows - 1 if rolling else 0
    h = min(max(h_roll, max((k for _, _, k in lags), default=0)), cap)
    arrays = []
    for c, x in zip(cols, st):
        a = {"lanes": x["plane"]}
        if rolling and x["scan"].shape[1]:
            a["vals"] = x["scan"]
        for _, col, _ in lags:
            a.setdefault(f"lag:{col}", c[col])
        arrays.append(a)
    if h > 0:
        halo, halo_ok = tail_halo(arrays, counts, h, group)
    else:
        halo = [{k: v[:0] for k, v in a.items()} for a in arrays]
        halo_ok = [torch.zeros(0, dtype=torch.bool, device=dev)] * p
    for s, (c, x) in enumerate(zip(cols, st)):
        ext_valid = torch.cat([halo_ok[s], x["mask"]])
        ext_plane = torch.cat([halo[s]["lanes"], x["plane"]])
        x["ext_seg"] = ext_seg = flag_starts(boundary_flags(ext_plane,
                                                            ext_valid))
        if distributed and h > 0:
            # truncation: lookback the halo could not prove (§2) — the
            # predecessor held fewer same-partition rows than the deepest
            # bounded lookback while the carry chain proves more exist
            need = torch.clamp(h - idx, min=0)
            carry_seg = torch.where(x["seg_start"] == 0, x["carry_cnt"], 0)
            avail = torch.clamp(h - ext_seg[h:], min=0)
            overflow[s] = overflow[s] + _i32((
                x["mask"] & (torch.minimum(need, carry_seg) > avail)).sum())
        for lb, col, k in lags:
            src_arr = torch.cat([halo[s][f"lag:{col}"], c[col]])
            src = h + idx - k
            ok = x["mask"] & (src >= ext_seg[h:])
            out[s][lb] = _bcast(ok, src_arr[torch.clamp(src, 0, h + cap - 1)])

        # ---- rolling: blocked windowed scan over the halo-extended rows ---
        sums, mm_out = None, {}
        if rolling:
            ext_idx = torch.arange(h + cap, device=dev)
            a_ext = torch.maximum(ext_idx - (rows - 1), ext_seg)
            cnt_win = (ext_idx - a_ext + 1)[h:]
            if x["scan"].shape[1]:
                ext_vals = (torch.cat([halo[s]["vals"], x["scan"]])
                            if h > 0 else x["scan"])
                if n_sum:
                    sums = wops.windowed_scan(ext_vals[:, :n_sum], ext_seg,
                                              rows, "sum")[h:]
                for i, (col, op) in enumerate(mm_items):
                    mm_out[(col, op)] = wops.windowed_scan(
                        ext_vals[:, n_sum + i], ext_seg, rows, op)[h:]
        else:
            if x["scan"].shape[1]:
                if n_sum:
                    sums = wops.segmented_cumulative(
                        x["scan"][:, :n_sum], x["seg_start"], "sum")
                for i, (col, op) in enumerate(mm_items):
                    mm_out[(col, op)] = wops.segmented_cumulative(
                        x["scan"][:, n_sum + i:n_sum + i + 1],
                        x["seg_start"], op)[:, 0]
            cnt_win = idx - x["seg_start"] + 1 + torch.where(
                x["seg_start"] == 0, x["carry_cnt"], 0)
        x["sums"], x["mm_out"], x["cnt_win"] = sums, mm_out, cnt_win

    # ---- cumulative: exact carry chain across shards ----------------------
    if distributed and not rolling and st[0]["scan"].shape[1]:
        if n_sum:
            cv = chain_carries(head_k, tail_k, pool(
                lambda x: torch.where(x["nonempty"], x["sums"][x["last"]],
                                      0.0)), whole, ne)
            for s, x in enumerate(st):
                x["sums"] = torch.where((x["seg_start"] == 0)[:, None],
                                        x["sums"] + cv[first + s][None, :],
                                        x["sums"])
        for key in mm_items:
            cv = chain_carries(head_k, tail_k, pool(
                lambda x, key=key: torch.where(
                    x["nonempty"], x["mm_out"][key][x["last"]], 0.0)),
                whole, ne, op=key[1])
            for s, x in enumerate(st):
                v = x["mm_out"][key]
                x["mm_out"][key] = torch.where(
                    x["seg_start"] == 0, _combine(key[1], v, cv[first + s]),
                    v)

    # ---- leads: forward halo, dynamic gather across the boundary ----------
    if leads:
        kmax = min(max(k for _, _, k in leads), cap)
        arrays = []
        for c, x in zip(cols, st):
            a = {"lanes": x["plane"]}
            for _, col, _ in leads:
                a.setdefault(f"lead:{col}", c[col])
            arrays.append(a)
        fhalo, fok = head_halo(arrays, counts, kmax, group)
        for s, (c, x) in enumerate(zip(cols, st)):
            # same-partition prefix of the forward halo, per local row: the
            # chain breaks at the first invalid or different-key halo row
            if len(pkeys):
                eq = (fhalo[s]["lanes"][None, :, :]
                      == x["plane"][:, None, :]).all(dim=2) & fok[s][None, :]
            else:
                eq = fok[s][None, :].expand(cap, kmax)
            # leading run of same-partition halo rows: the first mismatch
            # (a 1-D-per-row cumprod is a serial scan on CUDA)
            avail_f = torch.where(eq.all(dim=1), kmax,
                                  (~eq).to(torch.uint8).argmax(dim=1))
            ended = (avail_f < kmax) & fok[s][torch.clamp(avail_f, 0,
                                                          kmax - 1)]
            count, seg_start = x["count"], x["seg_start"]
            for lb, col, k in leads:
                src = idx + k
                srcc = torch.clamp(src, 0, cap - 1)
                local_ok = x["mask"] & (src < count) & (
                    seg_start[srcc] == seg_start)
                hj = src - count
                halo_ok = x["mask"] & (hj >= 0) & (hj < avail_f)
                hv = fhalo[s][f"lead:{col}"][torch.clamp(hj, 0, kmax - 1)]
                lv = c[col][srcc]
                out[s][lb] = torch.where(
                    local_ok.reshape((-1,) + (1,) * (lv.dim() - 1)), lv,
                    _bcast(halo_ok, hv))
            if distributed:
                # truncation is only possible for rows whose partition
                # reaches the local end (the shard's last segment) while a
                # later shard still holds rows — otherwise the table
                # provably ends and every lead is exact
                in_tail_seg = seg_start == seg_start[x["last"]]
                later_ne = ne[first + s + 1:].any()
                need_f = torch.clamp(idx + kmax - (count - 1), min=0)
                trunc = (x["mask"] & in_tail_seg & (need_f > avail_f)
                         & ~ended).sum()
                overflow[s] = overflow[s] + _i32(trunc * later_ne)

    # ---- ranking and value-agg lanes --------------------------------------
    for s, x in enumerate(st):
        mask, seg_start = x["mask"], x["seg_start"]
        head = torch.where(seg_start == 0, x["carry_cnt"], 0)
        if need_rn:
            out[s]["row_number"] = _i32(torch.where(
                mask, idx - seg_start + 1 + head, 0))
        if need_rank:
            out[s]["rank"] = _i32(torch.where(
                mask, x["run_start"] - seg_start + 1 + head
                - torch.where(x["run_start"] == 0, x["carry_run"], 0), 0))
        cnt_win = x["cnt_win"]
        cnt_f = torch.clamp(cnt_win.to(torch.float32), min=1.0)
        for lb, col, op, _ in aggs:
            if op == "count":
                out[s][lb] = _i32(torch.where(mask, cnt_win, 0))
            elif op == "sum":
                out[s][lb] = _bcast(mask, x["sums"][:, sum_cols.index(col)])
            elif op == "mean":
                out[s][lb] = _bcast(
                    mask, x["sums"][:, sum_cols.index(col)] / cnt_f)
            elif op in ("min", "max"):
                out[s][lb] = _bcast(mask, x["mm_out"][(col, op)])
    return out, overflow
