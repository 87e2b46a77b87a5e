"""Sliding-window mean-shift clustering (mean_shift_segmentation.{h,cc}).

Reference behavior (pointcloud_segmentation/
mean_shift_segmentation.h:207-330):
  * every unlabeled non-NaN point seeds a mode; a fixed number of shift
    iterations moves each seed by the mean of its neighbors inside an 11x11
    index window and a 1 m^2 spatial ball (flat kernel), tracking the shift
    in both 3-D space and fractional 2-D grid index (:232-260);
  * seeds whose window support drops below 0.5 * 4 * half^2 = 50 are
    invalidated (sticky) (:244-249);
  * surviving modes are processed by ascending intensity; each grows a
    cluster region (inlier if within 1 m^2 of the mode, or within 0.2^2 of
    an already-accepted neighbor; the first expansion ignores the neighbor
    rule), accepted regions suppress later modes within 1 m^2, rejected
    regions revert to kUnlabeled (:262-328).

Device/host split: the shift fixed point is embarrassingly parallel over
seeds — one batched fori_loop with 121 window gathers per iteration runs
entirely on device. The mode ordering + sequential growth is inherently
order-dependent over a small surviving set and runs on host (exact FIFO
port). Known divergence: the C++ sorts modes with std::sort (unstable);
exact intensity ties may order differently — we use a stable sort with the
original seed position as tiebreak.
"""

from __future__ import annotations

from collections import deque
import functools
from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pcseg_tpu.ops import nansafe
from pcseg_tpu.models.config import (
    UNLABELED, ClusterRegionConfig, MeanShiftParams)


class MeanShiftState(NamedTuple):
    pos: jnp.ndarray        # [N, 3] current seed positions
    idx: jnp.ndarray        # [N, 2] fractional (row, col) indices
    valid: jnp.ndarray      # [N] sticky validity
    intensity: jnp.ndarray  # [N] last window support
    is_seed: jnp.ndarray    # [N] participated at all (unlabeled, finite)


def mean_shift_modes(points: jnp.ndarray, labels: jnp.ndarray,
                     iterations: int,
                     params: MeanShiftParams = MeanShiftParams()
                     ) -> MeanShiftState:
    """Batched shift fixed point over every eligible pixel (device).

    points: [H, W, 3]; labels: [H, W] int32 (only UNLABELED pixels seed and
    only they contribute to windows, mean_shift_segmentation.h:112-115).
    """
    h, w = points.shape[0], points.shape[1]
    n = h * w
    dtype = points.dtype
    hw = params.half_search_window

    flat_pts = points.reshape(n, 3)
    finite = nansafe.all_finite(flat_pts)
    unlabeled = (labels == UNLABELED).reshape(n)
    is_seed = finite & unlabeled

    rows = (jnp.arange(n, dtype=jnp.int32) // w).astype(dtype)
    cols = (jnp.arange(n, dtype=jnp.int32) % w).astype(dtype)
    idx0 = jnp.stack([rows, cols], axis=-1)
    pos0 = jnp.where(is_seed[:, None], nansafe.sanitize(flat_pts), 0.0)

    neighbor_ok_grid = (unlabeled & finite).reshape(n)

    offsets = [(dr, dc) for dc in range(-hw, hw + 1)
               for dr in range(-hw, hw + 1)]

    def body(_, state):
        pos, idx, valid, intensity = state
        r = jnp.round(idx[:, 0]).astype(jnp.int32)
        c = jnp.round(idx[:, 1]).astype(jnp.int32)

        sum_dpos = jnp.zeros_like(pos)
        sum_didx = jnp.zeros_like(idx)
        count = jnp.zeros((n,), dtype)
        for dr, dc in offsets:
            rr = r + dr
            cc = c + dc
            inb = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
            lin = jnp.clip(rr * w + cc, 0, n - 1)
            q = flat_pts[lin]
            ok = inb & neighbor_ok_grid[lin]
            dpos = q - pos
            d2 = jnp.sum(dpos * dpos, axis=-1)
            ok = ok & (d2 <= params.square_distance_threshold)
            okf = ok.astype(dtype)
            sum_dpos = sum_dpos + jnp.where(ok[:, None], dpos, 0.0)
            didx = jnp.stack([rr.astype(dtype) - idx[:, 0],
                              cc.astype(dtype) - idx[:, 1]], axis=-1)
            sum_didx = sum_didx + jnp.where(ok[:, None], didx, 0.0)
            count = count + okf

        enough = count >= params.min_support
        new_valid = valid & enough
        denom = jnp.where(count > 0, count, 1.0)
        upd = new_valid
        pos = jnp.where(upd[:, None], pos + sum_dpos / denom[:, None], pos)
        idx = jnp.where(upd[:, None], idx + sum_didx / denom[:, None], idx)
        intensity = jnp.where(upd, count, intensity)
        return pos, idx, valid & enough, intensity

    init = (pos0, idx0, is_seed, jnp.ones((n,), dtype))
    pos, idx, valid, intensity = jax.lax.fori_loop(
        0, iterations, body, init)
    return MeanShiftState(pos=pos, idx=idx, valid=valid & is_seed,
                          intensity=intensity, is_seed=is_seed)


class MeanShiftRegion(NamedTuple):
    label_id: int
    inlier_indices: np.ndarray  # col-major linear, BFS order
    seed: np.ndarray            # mode position [3]


def grow_mean_shift_regions(points: np.ndarray, labels: np.ndarray,
                            state: MeanShiftState,
                            config: ClusterRegionConfig,
                            initial_region_id_offset: int = 0,
                            params: MeanShiftParams = MeanShiftParams()
                            ) -> List[MeanShiftRegion]:
    """Host pass: mode ordering, sequential growth, suppression — exact
    FIFO port of mean_shift_segmentation.h:262-328. Mutates ``labels``."""
    h, w = points.shape[0], points.shape[1]
    pos = np.asarray(state.pos)
    idx = np.asarray(state.idx)
    valid = np.asarray(state.valid)
    intensity = np.asarray(state.intensity)

    order = np.nonzero(valid)[0]
    # ascending intensity; stable with original seed order as tiebreak
    order = order[np.argsort(intensity[order], kind="stable")]

    regions: List[MeanShiftRegion] = []
    suppressed = np.zeros(len(valid), bool)
    hw_win = config.half_search_window

    for i, s in enumerate(order):
        if suppressed[s]:
            continue
        seed_pos = pos[s].astype(np.float32)
        label_id = len(regions) + initial_region_id_offset
        inliers = []
        q = deque()
        r0 = int(round(float(idx[s, 0])))
        c0 = int(round(float(idx[s, 1])))
        q.append(r0 * w + c0)
        first = True
        while q:
            center = q.popleft()
            cr, cc = center // w, center % w
            center_pt = points[cr, cc]
            for dc in range(-hw_win, hw_win + 1):
                for dr in range(-hw_win, hw_win + 1):
                    if not first and dc == 0 and dr == 0:
                        continue
                    rr, ccc = cr + dr, cc + dc
                    if not (0 <= rr < h and 0 <= ccc < w):
                        continue
                    if labels[rr, ccc] != UNLABELED \
                            or np.any(np.isnan(points[rr, ccc])):
                        continue
                    cand = points[rr, ccc].astype(np.float32)
                    if float(np.sum((cand - seed_pos) ** 2)) \
                            > params.squared_centroid_distance_threshold:
                        if first or float(np.sum(
                                (cand - center_pt.astype(np.float32)) ** 2)) \
                                > params.squared_neighbor_distance_threshold:
                            continue
                    labels[rr, ccc] = label_id
                    inliers.append(ccc * h + rr)  # col-major output index
                    q.append(rr * w + ccc)
            first = False

        if len(inliers) >= config.min_region_inliers:
            later = order[i + 1:]
            d2 = np.sum((pos[later] - seed_pos) ** 2, axis=-1)
            suppressed[later[d2 < params.squared_centroid_distance_threshold]] = True
            regions.append(MeanShiftRegion(
                label_id=label_id,
                inlier_indices=np.asarray(inliers, np.int64),
                seed=seed_pos))
        else:
            for lin_cm in inliers:
                labels[lin_cm % h, lin_cm // h] = UNLABELED
    return regions


def _mode_members_impl(points, labels, seed_pos, start_lin, config,
                       params):
    """Device closure of one mode's growth (mean_shift_segmentation.h:152-199).

    The reference BFS accepts candidate c from source s iff
    ``d2(c, mode) <= 1`` or (not the first expansion and
    ``d2(c, s) <= 0.04``). The accepted set is therefore the closure of:
      * the window-connected component of the centroid ball containing the
        start pixel, plus
      * 0.04-edge window chains hanging off it (which may re-enter other
        ball components, joined to a fixed point).
    Same BFS-vs-closure divergence class as models/cluster.py (documented
    there): a candidate the BFS rejects through every enqueued source but
    that is closure-reachable joins here; <1% of points on coherent clouds.
    The first-expansion quirk (neighbor rule off for the start pixel) is
    closure-irrelevant except for 0.04-chains anchored ONLY at the start
    pixel — absorbed by the same budget.

    start_lin: ROW-major linear index of the rounded mode pixel.
    Returns [H, W] bool member mask (empty if the start pixel is claimed).
    """
    from pcseg_tpu.ops import connectivity

    h, w = points.shape[0], points.shape[1]
    hw = h * w
    finite = nansafe.all_finite(points)
    elig = (labels == UNLABELED) & finite
    d2seed = jnp.sum(jnp.square(points - seed_pos), axis=-1)
    ball = elig & (d2seed <= params.squared_centroid_distance_threshold)

    half = config.half_search_window
    comp_ball = connectivity.connected_components_window(
        points, ball, jnp.asarray(jnp.inf, points.dtype), half)
    comp_004 = connectivity.connected_components_window(
        points, elig,
        jnp.asarray(params.squared_neighbor_distance_threshold,
                    points.dtype), half)

    start = (jnp.arange(hw, dtype=jnp.int32).reshape(h, w)
             == start_lin) & ball

    offsets = [(dr, dc) for dc in range(-half, half + 1)
               for dr in range(-half, half + 1) if (dr, dc) != (0, 0)]

    def joined(r, comp, cells):
        table = connectivity.segment_field(
            r.astype(jnp.int32), comp, cells, h, w, "sum") > 0
        hit = table[jnp.clip(comp.reshape(-1), 0, hw - 1)].reshape(h, w)
        return r | (cells & (comp.reshape(h, w) < hw) & hit)

    def one_round(r):
        # window-dilate into the ball (entry from outside-ball members)
        d = r
        for dr, dc in offsets:
            d = d | connectivity._shift2(r, dr, dc, False)
        r = r | (ball & d)
        r = joined(r, comp_ball, ball)
        r = joined(r, comp_004, elig)
        return r

    def cond(state):
        r, prev = state
        return jnp.any(r != prev)

    def body(state):
        r, _ = state
        return one_round(r), r

    first = one_round(start)
    r, _ = jax.lax.while_loop(cond, body, (first, start))
    return r


def _grow_all_modes_impl(points, labels0, pos, idx, valid, intensity,
                         config, params, cap, initial_region_id_offset):
    """ALL surviving modes grown in ONE program.

    The reference's post-shift pass (mean_shift_segmentation.h:262-328) is
    sequential over modes; dispatching one jitted program per attempted
    mode pays one host round trip per mode. Here a single while_loop walks
    the intensity-ascending
    mode order on device: skipped modes (suppressed by an accepted region /
    start pixel claimed / out of bounds) cost one ~free loop iteration, and
    each *attempted* mode runs the same closure as _mode_members_impl under
    a lax.cond, so only genuine attempts pay the growth compute.

    Returns (labels, seeds_tab [cap, 3], counts_tab [cap], num_regions,
    overflow) — overflow set if an attempt was suppressed only by the
    static ``cap`` on the region table (the reference is unbounded).
    """
    h, w = points.shape[0], points.shape[1]
    n = h * w
    dtype = points.dtype
    key = jnp.where(valid, intensity, jnp.asarray(jnp.inf, dtype))
    order = jnp.argsort(key, stable=True)    # ascending; invalid modes last
    n_modes = jnp.sum(valid.astype(jnp.int32))

    def grow_closure(labels, seed_pos, start_lin):
        return _mode_members_impl(points, labels, seed_pos, start_lin,
                                  config, params)

    def body(st):
        (i, labels, suppressed, num_acc, seeds_tab, counts_tab,
         overflow) = st
        s = order[i]
        r0 = jnp.round(idx[s, 0]).astype(jnp.int32)
        c0 = jnp.round(idx[s, 1]).astype(jnp.int32)
        inb = (r0 >= 0) & (r0 < h) & (c0 >= 0) & (c0 < w)
        r0c = jnp.clip(r0, 0, h - 1)
        c0c = jnp.clip(c0, 0, w - 1)
        unclaimed = labels[r0c, c0c] == UNLABELED
        want = (~suppressed[s]) & inb & unclaimed
        do = want & (num_acc < cap)
        overflow = overflow | (want & (num_acc >= cap))
        seed_pos = pos[s]

        def attempt(operand):
            labels, suppressed, num_acc, seeds_tab, counts_tab = operand
            members = grow_closure(labels, seed_pos, r0 * w + c0)
            count = jnp.sum(members.astype(jnp.int32))
            accepted = count >= config.min_region_inliers
            label_id = num_acc + initial_region_id_offset
            labels = jnp.where(members & accepted, label_id, labels)
            # accepted regions suppress later modes within the centroid
            # ball (mean_shift_segmentation.h:313-321); marking earlier
            # (already-processed) modes too is harmless
            d2 = jnp.sum(jnp.square(pos - seed_pos), axis=-1)
            suppressed = suppressed | (
                accepted & valid
                & (d2 < params.squared_centroid_distance_threshold))
            seeds_tab = jnp.where(
                (jnp.arange(cap) == num_acc)[:, None] & accepted,
                seed_pos, seeds_tab)
            counts_tab = jnp.where(
                (jnp.arange(cap) == num_acc) & accepted, count, counts_tab)
            num_acc = num_acc + accepted.astype(jnp.int32)
            return labels, suppressed, num_acc, seeds_tab, counts_tab

        labels, suppressed, num_acc, seeds_tab, counts_tab = jax.lax.cond(
            do, attempt, lambda o: o,
            (labels, suppressed, num_acc, seeds_tab, counts_tab))
        return (i + 1, labels, suppressed, num_acc, seeds_tab, counts_tab,
                overflow)

    st0 = (jnp.int32(0), labels0,
           jnp.zeros((n,), bool), jnp.int32(0),
           jnp.zeros((cap, 3), dtype), jnp.zeros((cap,), jnp.int32),
           jnp.asarray(False))
    st = jax.lax.while_loop(lambda st: st[0] < n_modes, body, st0)
    _, labels, _, num_acc, seeds_tab, counts_tab, overflow = st
    return labels, seeds_tab, counts_tab, num_acc, overflow


# Module-level cached jits: the configs are frozen (hashable) dataclasses,
# so passing them static reuses one compiled program per parameterization
# across frames. Per-call ``jax.jit(lambda ...)`` wrappers would compile
# fresh on EVERY sliding_mean_shift call.
_mean_shift_modes_jit = functools.partial(
    jax.jit, static_argnums=(2, 3))(mean_shift_modes)


@functools.partial(jax.jit, static_argnums=(6, 7, 8, 9))
def _grow_all_modes_jit(p, l, pos, idx, v, it, config, params, cap, offset):
    return _grow_all_modes_impl(p, l, pos, idx, v, it, config, params, cap,
                                offset)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _mode_members_jit(p, l, s, i, config, params):
    return _mode_members_impl(p, l, s, i, config, params)


def grow_mean_shift_regions_batched(points, labels,
                                    state: MeanShiftState,
                                    config: ClusterRegionConfig,
                                    initial_region_id_offset: int = 0,
                                    params: MeanShiftParams
                                    = MeanShiftParams()
                                    ) -> List[MeanShiftRegion]:
    """One-dispatch growth of every surviving mode (see
    _grow_all_modes_impl). Mutates ``labels`` in place like the C++.
    Same closure-vs-BFS divergence class as grow_mean_shift_regions_device;
    inlier order is sorted col-major (documented divergence)."""
    h = points.shape[0]
    cap = int(config.max_regions)
    new_labels, seeds_tab, counts_tab, num_acc, overflow = jax.device_get(
        _grow_all_modes_jit(
            jnp.asarray(points), jnp.asarray(labels), state.pos, state.idx,
            state.valid, state.intensity, config, params, cap,
            initial_region_id_offset))
    if bool(overflow):
        import warnings
        warnings.warn(
            f"mean-shift region table full (max_regions={cap}): further "
            "modes were not attempted", stacklevel=2)
    labels[...] = new_labels
    regions: List[MeanShiftRegion] = []
    for rid in range(int(num_acc)):
        label_id = rid + initial_region_id_offset
        rr, cc = np.nonzero(new_labels == label_id)
        regions.append(MeanShiftRegion(
            label_id=label_id,
            inlier_indices=np.sort(cc * h + rr).astype(np.int64),
            seed=np.asarray(seeds_tab[rid], np.float32)))
    return regions


def grow_mean_shift_regions_device(points, labels, state: MeanShiftState,
                                   config: ClusterRegionConfig,
                                   initial_region_id_offset: int = 0,
                                   params: MeanShiftParams = MeanShiftParams()
                                   ) -> List[MeanShiftRegion]:
    """Mode ordering + suppression on host (exact, tiny), per-mode growth on
    device (one jitted closure per attempted mode). Mutates ``labels``."""
    h, w = points.shape[0], points.shape[1]
    pos = np.asarray(state.pos)
    idx = np.asarray(state.idx)
    valid = np.asarray(state.valid)
    intensity = np.asarray(state.intensity)

    order = np.nonzero(valid)[0]
    order = order[np.argsort(intensity[order], kind="stable")]

    def grow(p, l, s, i):
        return _mode_members_jit(p, l, s, i, config, params)
    points_j = jnp.asarray(points)

    regions: List[MeanShiftRegion] = []
    suppressed = np.zeros(len(valid), bool)
    for i, s in enumerate(order):
        if suppressed[s]:
            continue
        r0 = int(round(float(idx[s, 0])))
        c0 = int(round(float(idx[s, 1])))
        if not (0 <= r0 < h and 0 <= c0 < w):
            continue
        if labels[r0, c0] != UNLABELED:
            continue  # start pixel claimed -> empty attempt
        seed_pos = pos[s].astype(np.float32)
        members = np.asarray(grow(points_j, jnp.asarray(labels),
                                  jnp.asarray(seed_pos),
                                  jnp.int32(r0 * w + c0)))
        count = int(members.sum())
        if count >= config.min_region_inliers:
            label_id = len(regions) + initial_region_id_offset
            labels[members] = label_id
            later = order[i + 1:]
            d2 = np.sum((pos[later] - seed_pos) ** 2, axis=-1)
            suppressed[later[
                d2 < params.squared_centroid_distance_threshold]] = True
            rr, cc = np.nonzero(members)
            regions.append(MeanShiftRegion(
                label_id=label_id,
                inlier_indices=np.sort(cc * h + rr).astype(np.int64),
                seed=seed_pos))
    return regions


def sliding_mean_shift(points, labels, config: ClusterRegionConfig,
                       iterations: int, initial_region_id_offset: int = 0,
                       params: MeanShiftParams = MeanShiftParams(),
                       growth: str = "device"):
    """Full SlidingMeanShift: shift fixed point + region growth.

    Args mirror the reference entry point (mean_shift_segmentation.h:208).
    ``labels`` is numpy [H, W]; mutated in place like the C++. Returns the
    region list. ``growth``: "device" (ALL modes grown in one dispatched
    program), "device_permode" (one dispatch per attempted mode; the
    round-3 path, kept for equivalence testing), "host" (exact FIFO port,
    the parity oracle) or "native" (the C++ runtime runs modes AND growth
    in one call — hostops.pcseg_mean_shift_grid; no device dispatch at
    all, the organized serving fast path; mirrors the exact FIFO port).
    """
    if growth == "native":
        return _sliding_mean_shift_native(points, labels, config,
                                          iterations,
                                          initial_region_id_offset, params)
    state = _mean_shift_modes_jit(jnp.asarray(points), jnp.asarray(labels),
                                  iterations, params)
    if growth == "device":
        return grow_mean_shift_regions_batched(
            np.asarray(points), labels, state, config,
            initial_region_id_offset, params)
    if growth == "device_permode":
        return grow_mean_shift_regions_device(
            np.asarray(points), labels, state, config,
            initial_region_id_offset, params)
    return grow_mean_shift_regions(
        np.asarray(points), labels, state, config,
        initial_region_id_offset, params)


def _sliding_mean_shift_native(points, labels, config, iterations,
                               initial_region_id_offset, params):
    """growth='native': one hostops call for modes + growth (no device).

    Semantics mirror mean_shift_modes + grow_mean_shift_regions (the
    exact FIFO port); equality-tested on blob scenes incl. pre-labeled
    planar cells. The mode fixed point accumulates in f64 (vs the device
    path's f32) — agreement-tested, not bitwise."""
    import ctypes
    from pcseg_tpu import native as _native

    lib = _native.load_hostops()
    if lib is None:
        raise RuntimeError("native hostops unavailable for growth='native'")
    h, w = labels.shape
    pts = np.asarray(points, np.float32)
    occ = np.ascontiguousarray(
        np.isfinite(pts).all(axis=-1).astype(np.uint8))
    cells = np.ascontiguousarray(np.nan_to_num(pts, nan=0.0)
                                 .astype(np.float32))
    labels_c = np.ascontiguousarray(labels.astype(np.int32))
    n_regions = lib.pcseg_mean_shift_grid(
        cells.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, int(iterations), int(params.half_search_window),
        ctypes.c_float(params.square_distance_threshold),
        ctypes.c_float(params.min_support),
        ctypes.c_float(params.squared_centroid_distance_threshold),
        ctypes.c_float(params.squared_neighbor_distance_threshold),
        int(config.min_region_inliers), int(UNLABELED),
        int(initial_region_id_offset),
        labels_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    labels[...] = labels_c
    regions: List[MeanShiftRegion] = []
    for rid in range(n_regions):
        label_id = rid + initial_region_id_offset
        rr, cc = np.nonzero(labels_c == label_id)
        # seed positions live only inside the kernel; report the member
        # centroid (consumers use inlier sets/counts; documented)
        pts_sel = pts[rr, cc]
        regions.append(MeanShiftRegion(
            label_id=label_id,
            inlier_indices=np.sort(cc * h + rr).astype(np.int64),
            seed=pts_sel.mean(axis=0).astype(np.float32)
            if len(rr) else np.zeros(3, np.float32)))
    return regions
