"""Spatially-sharded segmentation over a device mesh.

The reference is single-threaded C++ with no distributed story (SURVEY.md
§5); this module is the multi-device design: the organized grid [H, W] is
sharded over **columns** across a 1-D mesh axis ("space"), every windowed op
exchanges halo rings with its neighbors (``ppermute``; NVLink between the
cards of one GPU host), plane-fit moments merge with
``psum`` (exact — the estimator's merge algebra is addition,
plane_estimator.cc:128-133), and cluster label unification runs local
min-propagation plus global pointer jumping. An optional "data" mesh axis
shards a batch of frames on top (BASELINE configs 4-5).

Semantics: identical to the single-device path with one documented
difference — seed ranking uses the corrected (natural) grid orientation
rather than the reference's transposed-access quirk (ops/seeds.py
docstring), since the quirk is only well-defined on square grids.

All collective control flow is replicated: every shard computes identical
region tables / plane solves from psum'd quantities, so the nested
while_loops stay in lockstep without extra synchronization.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from pcseg_tpu.models.config import (
    UNLABELED, EXAMINED, ClusterRegionConfig, ComputeNormalsParams,
    PlanarRegionConfig, SeedsFromPlaneSupportParams)
from pcseg_tpu.models import planar as planar_model
from pcseg_tpu.ops import geom, nansafe, plane_fit
from pcseg_tpu.ops import normals as normals_op
from pcseg_tpu.ops import seeds as seeds_op
from pcseg_tpu.ops.normals import _shift
from pcseg_tpu.parallel.halo import exchange_halo, crop_halo


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "space") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]).reshape(n), (axis_name,))


# ---------------------------------------------------------------------------
# building blocks (all called inside shard_map over ``axis``)
# ---------------------------------------------------------------------------

def _dilate4_halo(frontier, axis):
    """4-neighborhood dilation across shard boundaries (halo 1)."""
    pad = exchange_halo(frontier, 1, axis, fill=False)
    return crop_halo(planar_model._dilate4(pad), 1)


def _gather_seed_values(grid_local, seed_indices, h, w_local, axis):
    """Values of a local [H, W_local(, C)] grid at *global* col-major seed
    indices, combined across shards with psum (each in-range index is owned
    by exactly one shard; non-owners contribute zero)."""
    shard = lax.axis_index(axis)
    r = seed_indices % h
    c_glob = seed_indices // h
    c_local = c_glob - shard * w_local
    owned = (c_local >= 0) & (c_local < w_local)
    c_safe = jnp.clip(c_local, 0, w_local - 1)
    flat = grid_local.reshape((h * w_local,) + grid_local.shape[2:])
    vals = flat[(r * w_local + c_safe).reshape(-1)].reshape(
        seed_indices.shape + grid_local.shape[2:])
    mask = owned.reshape(owned.shape + (1,) * (vals.ndim - owned.ndim))
    return lax.psum(jnp.where(mask, vals, 0), axis)


def sharded_normals(points_local, sensor_origin,
                    params: ComputeNormalsParams, axis):
    """Organized normals on a column shard — exact vs single device.

    Needs halo = max_scan_steps columns; a NaN halo at the true grid edges
    reproduces the single-device edge semantics (the scan just never finds
    a neighbor there). The directional-scan moments must be accumulated
    over the halo'd block, but the eigensolve — the expensive half — runs
    on LOCAL columns only (the support pytree is cropped first); solving
    halo columns too was pure duplicated work across shards."""
    k = params.max_scan_steps
    padded = exchange_halo(points_local, k, axis, fill=jnp.nan)
    support = normals_op.find_normal_support(padded, params)
    support = jax.tree.map(lambda x: crop_halo(x, k), support)
    return normals_op.normals_from_support(support, points_local,
                                           sensor_origin, params)


def sharded_plane_support_seeds(points_local, normals_local,
                                params: SeedsFromPlaneSupportParams,
                                h, w, axis):
    """Globally-ranked plane-support seeds from column shards.

    Local windowed counts with halo = window//2, then each shard keeps its
    local top-``max_seeds`` candidates and only THOSE are all-gathered
    (O(n * max_seeds) ints instead of the full O(H * W) count grid); the
    global top-``max_seeds`` is a subset of the per-shard top lists, so
    the merged replicated ranking is exactly rank_plane_support_seeds'.
    """
    half = params.neighborhood_size // 2
    max_seeds = params.max_seeds
    pp = exchange_halo(points_local, half, axis, fill=jnp.nan)
    np_ = exchange_halo(normals_local, half, axis, fill=jnp.nan)
    count_pad, ok_pad = seeds_op.plane_support_counts(pp, np_, params)
    count = crop_halo(count_pad, half)
    ok = crop_halo(ok_pad, half)

    w_local = count.shape[1]
    shard = lax.axis_index(axis)
    rows = lax.broadcasted_iota(jnp.int32, (h, w_local), 0)
    cols = lax.broadcasted_iota(jnp.int32, (h, w_local), 1) \
        + shard * w_local
    lin = cols * h + rows
    qualifies = ok & (count >= params.min_num_support_points)
    # same key as rank_plane_support_seeds: (count asc, col-major lin asc)
    key = jnp.where(qualifies, count * (h * w) + lin, -1).reshape(-1)
    m_local = min(max_seeds, key.shape[0])
    kk, ii = lax.top_k(key, m_local)                 # descending
    lin_k = lin.reshape(-1)[ii]

    keys_all = lax.all_gather(kk, axis).reshape(-1)
    lins_all = lax.all_gather(lin_k, axis).reshape(-1)
    k2 = min(max_seeds, keys_all.shape[0])
    kk2, jj = lax.top_k(keys_all, k2)                # global top, descending
    # final vector ascending (driver pops back-to-front -> best first),
    # front-padded with invalid entries when fewer than max_seeds exist
    pad = max_seeds - k2
    indices = jnp.concatenate(
        [jnp.zeros((pad,), jnp.int32), lins_all[jj][::-1]])
    valid = jnp.concatenate(
        [jnp.zeros((pad,), bool), (kk2 >= 0)[::-1]])
    return jnp.where(valid, indices, 0), valid


def sharded_plane_support_rank_grid(points_local, normals_local,
                                    params: SeedsFromPlaneSupportParams,
                                    h, w, axis):
    """Local [H, W_local] slice of the dense seed pop-priority grid
    (ops/seeds.plane_support_rank_grid semantics, natural orientation) —
    covers EVERY qualifying seed; no top-k truncation, no gathers."""
    half = params.neighborhood_size // 2
    pp = exchange_halo(points_local, half, axis, fill=jnp.nan)
    np_ = exchange_halo(normals_local, half, axis, fill=jnp.nan)
    count_pad, ok_pad = seeds_op.plane_support_counts(pp, np_, params)
    count = crop_halo(count_pad, half)
    ok = crop_halo(ok_pad, half)
    qualifies = ok & (count >= params.min_num_support_points)

    w_local = count.shape[1]
    shard = lax.axis_index(axis)
    rows = lax.broadcasted_iota(jnp.int32, (h, w_local), 0)
    cols = lax.broadcasted_iota(jnp.int32, (h, w_local), 1) \
        + shard * w_local
    lin = cols * h + rows
    hw = h * w
    cmax = params.neighborhood_size ** 2 + 1
    rank = (cmax - count) * hw + (hw - 1 - lin)
    return jnp.where(qualifies, rank, seeds_op.SEED_RANK_INF)


def _ungather(gathered, h, w):
    """[n_shards, H, W_local, ...] -> [H, W, ...] (columns concatenated)."""
    moved = jnp.moveaxis(gathered, 0, 1)         # [H, n, W_local, ...]
    return moved.reshape((h, w) + gathered.shape[3:])


def sharded_grow_planar_regions(points_local, normals_local, labels_local,
                                seed_indices, seed_valid,
                                config: PlanarRegionConfig,
                                h, w, axis,
                                initial_id_offset: int = 0,
                                max_attempts: int = 256):
    """Column-sharded SegmentRegions<PlanarRegion> (models/planar.py).

    Wavefronts dilate across shard boundaries via halo exchange; moment
    accumulators and counts merge with psum (exact); all scalar control
    state is replicated so every shard runs the identical attempt loop.
    """
    w_local = points_local.shape[1]
    dtype = points_local.dtype
    r_cap = config.max_regions
    tau = jnp.asarray(config.max_plane_distance, dtype)
    period = config.plane_model_reestimation_period
    min_inliers = config.min_region_inliers

    s = seed_indices.shape[0]
    seed_order = jnp.arange(s, dtype=jnp.int32)

    regions0 = planar_model.PlanarRegions(
        labels=labels_local,
        num_regions=jnp.int32(0),
        planes=jnp.zeros((r_cap, 4), dtype),
        centroids=jnp.zeros((r_cap, 3), dtype),
        curvatures=jnp.zeros((r_cap,), dtype),
        counts=jnp.zeros((r_cap,), jnp.int32),
        seed_indices=jnp.zeros((r_cap,), jnp.int32),
        moments=plane_fit.empty((r_cap,), dtype),
        overflow=jnp.bool_(False),
    )

    shard = lax.axis_index(axis)

    def local_onehot(seed_idx):
        r = seed_idx % h
        c_glob = seed_idx // h
        c_local = c_glob - shard * w_local
        owned = (c_local >= 0) & (c_local < w_local)
        c_safe = jnp.clip(c_local, 0, w_local - 1)
        grid = jnp.zeros((h, w_local), bool).at[r, c_safe].set(True)
        return grid & owned

    def grow_one(labels_in, seed_idx):
        seed_point = _gather_seed_values(
            points_local, seed_idx[None], h, w_local, axis)[0]
        seed_normal = _gather_seed_values(
            normals_local, seed_idx[None], h, w_local, axis)[0]
        plane0 = geom.plane_from_normal_point(seed_normal, seed_point)
        m0 = plane_fit.set_normal_orientation(
            plane_fit.empty((), dtype), seed_normal)
        frontier0 = local_onehot(seed_idx)
        member0 = jnp.zeros((h, w_local), bool)
        eligible = labels_in == UNLABELED

        def cond(state):
            _, _, _, _, _, it, active = state
            return active & (it < config.max_growth_iters)

        def body(state):
            member, frontier, plane, m, count, it, _ = state
            first = it == 0
            cand = jnp.where(first, frontier,
                             _dilate4_halo(frontier, axis)
                             & eligible & ~member)
            dist = jnp.abs(
                jnp.sum(plane[:3] * points_local, axis=-1) + plane[3])
            accepted = cand & (dist < tau)
            new_member = member | accepted
            dm_s2, dm_s1, dm_w = plane_fit.moments_of_points(
                jnp.where(accepted[..., None], points_local,
                          0.0).reshape(-1, 3),
                accepted.astype(dtype).reshape(-1))
            # exact cross-shard merge: accumulator addition == psum
            dm_s2 = lax.psum(dm_s2, axis)
            dm_s1 = lax.psum(dm_s1, axis)
            dm_w = lax.psum(dm_w, axis)
            new_m = m._replace(s2=m.s2 + dm_s2, s1=m.s1 + dm_s1,
                               w=m.w + dm_w)
            n_accepted = lax.psum(jnp.sum(accepted.astype(jnp.int32)), axis)
            new_count = count + n_accepted

            crossed = (new_count // period) > (count // period)

            def reestimate(args):
                mm, pl = args
                sol = plane_fit.solve(mm)
                new_hint = jnp.where(sol.valid, sol.normal, mm.normal_hint)
                recentered = geom.plane_from_normal_point(
                    mm.normal_hint, sol.centroid)
                return mm._replace(normal_hint=new_hint), \
                    jnp.where(sol.valid, sol.plane, recentered)

            new_m, new_plane = jax.lax.cond(
                crossed, reestimate, lambda a: a, (new_m, plane))
            next_frontier = jnp.where(crossed, new_member, accepted)
            active = (n_accepted > 0) | crossed
            return (new_member, next_frontier, new_plane, new_m, new_count,
                    it + 1, active)

        member, _, plane, m, count, _, _ = jax.lax.while_loop(
            cond, body,
            (member0, frontier0, plane0, m0, jnp.int32(0), jnp.int32(0),
             jnp.bool_(True)))
        return member, plane, m, count

    def attempt_cond(state):
        regions, consumed, attempts = state
        seed_labels = _gather_seed_values(
            regions.labels, seed_indices, h, w_local, axis)
        available = seed_valid & ~consumed & (seed_labels == UNLABELED)
        return jnp.any(available) & (attempts < max_attempts) \
            & (regions.num_regions < r_cap)

    def attempt_body(state):
        regions, consumed, attempts = state
        seed_labels = _gather_seed_values(
            regions.labels, seed_indices, h, w_local, axis)
        available = seed_valid & ~consumed & (seed_labels == UNLABELED)
        pos = jnp.where(available, seed_order, -1)
        pick = jnp.argmax(pos)
        seed_idx = seed_indices[pick]
        consumed = consumed.at[pick].set(True)

        member, plane, m, count = grow_one(regions.labels, seed_idx)
        accept = count >= min_inliers
        rid = regions.num_regions
        label_val = jnp.where(accept, rid + initial_id_offset,
                              jnp.int32(EXAMINED))
        new_labels = jnp.where(member, label_val, regions.labels)
        sol = plane_fit.solve(m._replace(normal_hint=plane[:3]))

        def write(r):
            return r._replace(
                num_regions=rid + 1,
                planes=r.planes.at[rid].set(
                    jnp.where(sol.valid, sol.plane, plane)),
                centroids=r.centroids.at[rid].set(sol.centroid),
                curvatures=r.curvatures.at[rid].set(sol.curvature),
                counts=r.counts.at[rid].set(count),
                seed_indices=r.seed_indices.at[rid].set(seed_idx),
                moments=plane_fit.PlaneMoments(
                    s2=r.moments.s2.at[rid].set(m.s2),
                    s1=r.moments.s1.at[rid].set(m.s1),
                    w=r.moments.w.at[rid].set(m.w),
                    normal_hint=r.moments.normal_hint.at[rid].set(
                        m.normal_hint)),
            )

        regions = jax.lax.cond(
            accept, write, lambda r: r, regions._replace(labels=new_labels))
        return regions, consumed, attempts + 1

    regions, consumed, attempts = jax.lax.while_loop(
        attempt_cond, attempt_body,
        (regions0, jnp.zeros((s,), bool), jnp.int32(0)))

    final_labels = jnp.where(regions.labels == EXAMINED, UNLABELED,
                             regions.labels)
    overflow = (attempts >= max_attempts) | (regions.num_regions >= r_cap)
    return regions._replace(labels=final_labels, overflow=overflow)


def _sharded_flood_packed(gate, sources, axis, rounds, max_run=None,
                          global_rounds=16):
    """Cross-shard batched flood fill on packed bit-planes.

    gate/sources: [K, H, W_local] bool (columns sharded over ``axis``).
    Per global round: local segmented-scan flood to its fixed point
    (models/planar_batched.flood_fill_static's body), then a ONE-COLUMN
    halo exchange ORs boundary reach into the neighbors — comm volume
    O(NW * H) per round instead of any full-grid gather. Global rounds
    needed = number of times the region winds across shard boundaries.
    """
    from pcseg_tpu.models import planar_batched as pb

    g = pb._pack_bits(gate)
    not_g = ~g
    reach0 = pb._pack_bits(sources & gate)

    def local_round(reach):
        reach = pb._segmented_or_spread_packed(reach, g, not_g, -1, max_run)
        return pb._segmented_or_spread_packed(reach, g, not_g, -2, max_run)

    def local_flood(reach):
        def cond(st):
            r, prev, it = st
            return (it < rounds) & jnp.any(r != prev)

        def body(st):
            r, _, it = st
            return local_round(r), r, it + 1

        first = local_round(reach)
        r, _, _ = jax.lax.while_loop(cond, body, (first, reach, jnp.int32(1)))
        return r

    def exchange(reach):
        padded = exchange_halo(reach, 1, axis, fill=0, axis=2)
        incoming_left = padded[..., 0]     # neighbor's right edge column
        incoming_right = padded[..., -1]   # neighbor's left edge column
        reach = reach.at[..., 0].set(
            reach[..., 0] | (incoming_left & g[..., 0]))
        reach = reach.at[..., -1].set(
            reach[..., -1] | (incoming_right & g[..., -1]))
        return reach

    def gcond(st):
        r, prev, it = st
        changed = lax.psum(jnp.sum((r != prev).astype(jnp.int32)), axis) > 0
        return (it < global_rounds) & changed

    def gbody(st):
        r, _, it = st
        return exchange(local_flood(r)), r, it + 1

    first = exchange(local_flood(reach0))
    reach, _, _ = jax.lax.while_loop(gcond, gbody,
                                     (first, reach0, jnp.int32(1)))
    # last exchange may have seeded edge cells; flood them locally
    reach = local_flood(reach)
    return pb._unpack_bits(reach, gate.shape[0])


class _ShardedGrowerBackend:
    """Column-sharded hooks for the unified batched grower core
    (models/planar_batched.GrowerBackend contract): psum/pmin collectives,
    halo-exchanging flood and ring dilation, owner-resolved cell gathers.
    Everything replicated-shaped is identical on all shards, so the core's
    control flow stays in lockstep."""

    def __init__(self, axis, h, w_total, w_local):
        from pcseg_tpu.models import planar_batched as pb
        self._pb = pb
        self.axis = axis
        self.h = h
        self.w_total = w_total
        self.w_local = w_local
        self.col0 = lax.axis_index(axis) * w_local

    def psum(self, x):
        return lax.psum(x, self.axis)

    def pmin(self, x):
        return lax.pmin(x, self.axis)

    def pmax(self, x):
        return lax.pmax(x, self.axis)

    def flood(self, gate, src, rounds):
        return _sharded_flood_packed(gate, src, self.axis, rounds)

    def dilate_rings(self, members, gate, n):
        pb = self._pb
        g = pb._pack_bits(gate)
        m = pb._pack_bits(members & gate)
        for _ in range(n):
            mp = exchange_halo(m, 1, self.axis, fill=0, axis=2)
            nb = (mp[..., :-2] | mp[..., 2:]
                  | pb._shift_axis(m, 1, -2, 0)
                  | pb._shift_axis(m, -1, -2, 0))
            m = m | (nb & g)
        return pb._unpack_bits(m, members.shape[0])

    def dilate4(self, members):
        pb = self._pb
        mp = exchange_halo(members, 1, self.axis, fill=False, axis=2)
        return (members | mp[..., :-2] | mp[..., 2:]
                | pb._shift_mask(members, 1, 0)
                | pb._shift_mask(members, -1, 0))

    def gather_cells(self, points, normals, lin_idx):
        h = points.shape[0]
        wl = points.shape[1]
        r = lin_idx % h
        c_l = jnp.clip(lin_idx // h, 0, self.w_total - 1) - self.col0
        owned = (c_l >= 0) & (c_l < wl)
        c_s = jnp.clip(c_l, 0, wl - 1)
        # NaN values would poison the ownership psum; callers only gather
        # cell_ok (finite) seeds, so zeroing is invisible
        pt = jnp.where(owned[:, None], nansafe.sanitize(points[r, c_s]), 0.0)
        nm = jnp.where(owned[:, None], nansafe.sanitize(normals[r, c_s]), 0.0)
        return lax.psum(pt, self.axis), lax.psum(nm, self.axis)


def sharded_grow_planar_regions_batched(
        points_local, normals_local, labels_local,
        seed_indices, seed_valid,
        config: PlanarRegionConfig,
        h, w, axis,
        initial_id_offset: int = 0,
        **grower_kwargs):
    """Column-sharded PRODUCTION batched grower: the *single* grower core
    (models/planar_batched.grow_planar_regions_batched) run under shard_map
    with collective hooks — single-chip and multi-chip execute the same
    algorithm by construction. Cross-shard pieces: flood / ring dilation =
    one-column halo exchanges, plane refits and counts = psums of the
    moment matmul (exact — the estimator merge algebra is addition,
    plane_estimator.cc:128-133), founder/anchor election = pmin with
    unique-rank owner resolution.

    Labels in the result are the LOCAL column shard; slot tables are
    replicated. f32 reduction order differs from the single-device path
    (per-shard partials then psum), so degenerate knife-edge fits can
    resolve differently — the same tolerance class as the reference's own
    accumulation-order sensitivity (plane_estimator_test.cc:34-36).
    """
    from pcseg_tpu.models import planar_batched as pb

    bk = _ShardedGrowerBackend(axis, h, w, points_local.shape[1])
    return pb.grow_planar_regions_batched(
        points_local, normals_local, labels_local, seed_indices, seed_valid,
        config, initial_id_offset, backend=bk, **grower_kwargs)


def sharded_connected_components(points_local, eligible_local,
                                 squared_threshold, half_window,
                                 h, w, axis, max_rounds=128,
                                 uf_rounds: int = 16):
    """Column-sharded gated CCL — boundary-pair unification.

    1. Local gated CCL on each column shard to its fixed point, with
       labels seeded by GLOBAL col-major indices (ops/connectivity
       segmented min-scans; no communication).
    2. Cross-boundary equivalence pairs: for every gated window edge that
       crosses a shard boundary, the pair (local root, neighbor root) —
       O(H * k^2) pairs per shard (one k-column halo exchange), NOT the
       O(H * W * rounds) full-grid all_gathers of the naive scheme.
    3. One all_gather of the pair lists, then replicated union-find:
       scatter-min union rounds + pointer jumping on an [H*W] parent
       table (pure local compute), and a final root remap of the local
       labels. The per-root minimum over the union is exactly the global
       component minimum, so roots equal the single-device CCL's.

    Matches SURVEY §5's long-context/SP design (boundary-ring equivalence
    exchange + pointer jumping).
    """
    w_local = points_local.shape[1]
    hw = h * w
    big = jnp.int32(hw)
    shard = lax.axis_index(axis)
    k = half_window

    # --- 1. local CCL with global labels ------------------------------------
    rows = lax.broadcasted_iota(jnp.int32, (h, w_local), 0)
    cols = lax.broadcasted_iota(jnp.int32, (h, w_local), 1) \
        + shard * w_local
    init = cols * h + rows
    from pcseg_tpu.ops import connectivity
    labels = connectivity.connected_components_scan(
        points_local, eligible_local,
        jnp.asarray(squared_threshold, points_local.dtype), k,
        rounds=max_rounds, init_labels=init, big_value=hw)

    # --- 2. boundary equivalence pairs (rightward edges only; leftward
    # edges are the left neighbor's rightward ones) --------------------------
    pp = exchange_halo(points_local, k, axis, fill=jnp.nan)
    ep = exchange_halo(eligible_local, k, axis, fill=False)
    lp = exchange_halo(labels, k, axis, fill=big)

    pair_a = []
    pair_b = []
    for dc in range(1, k + 1):
        for dr in range(-k, k + 1):
            # source cells: the last dc local columns; target (r+dr, c+dc)
            # lives in the right halo
            src_pts = points_local[:, w_local - k:]
            src_lab = labels[:, w_local - k:]
            src_ok = eligible_local[:, w_local - k:]
            # padded coords of the same strip start at w_local (+k halo -k)
            dst_pts = _shift(pp, -dr, -dc, jnp.nan)[:, w_local:w_local + k]
            dst_lab = _shift(lp, -dr, -dc, big)[:, w_local:w_local + k]
            dst_ok = _shift(ep, -dr, -dc, False)[:, w_local:w_local + k]
            crosses = (lax.broadcasted_iota(jnp.int32, (h, k), 1)
                       + dc) >= k  # local col c = w_local-k+j; c+dc >= w_local
            d2 = jnp.sum(jnp.square(dst_pts - src_pts), axis=-1)
            ok = (d2 < squared_threshold) & src_ok & dst_ok & crosses
            pair_a.append(jnp.where(ok, src_lab, big).reshape(-1))
            pair_b.append(jnp.where(ok, dst_lab, big).reshape(-1))
    a = jnp.concatenate(pair_a)
    b = jnp.concatenate(pair_b)

    # --- 3. replicated union-find over the gathered pairs -------------------
    a_all = lax.all_gather(a, axis).reshape(-1)
    b_all = lax.all_gather(b, axis).reshape(-1)
    a_safe = jnp.clip(a_all, 0, hw - 1)
    b_safe = jnp.clip(b_all, 0, hw - 1)
    valid = (a_all < hw) & (b_all < hw)

    parent0 = jnp.arange(hw + 1, dtype=jnp.int32)

    def uf_cond(state):
        parent, prev, it = state
        return (it < uf_rounds) & jnp.any(parent != prev)

    def uf_body(state):
        parent, _, it = state
        pa = parent[jnp.where(valid, a_safe, hw)]
        pb = parent[jnp.where(valid, b_safe, hw)]
        m = jnp.minimum(pa, pb)
        parent = parent.at[pa].min(jnp.where(valid, m, hw))
        parent = parent.at[pb].min(jnp.where(valid, m, hw))
        # pointer jumping (path compression)
        parent = parent[parent]
        parent = parent[parent]
        return parent, state[0], it + 1

    first = uf_body((parent0, parent0, jnp.int32(0)))[0]
    parent, _, _ = jax.lax.while_loop(
        uf_cond, uf_body, (first, parent0, jnp.int32(1)))

    remapped = parent[jnp.clip(labels, 0, hw)]
    return jnp.where(eligible_local, remapped, big)


class ShardedStepResult(NamedTuple):
    labels: jnp.ndarray          # [H, W] final combined label grid
    normals: jnp.ndarray         # [H, W, 3]
    planar: planar_model.PlanarRegions  # replicated region table
    num_clusters: jnp.ndarray


def build_sharded_segment_step(mesh: Mesh,
                               normals_params=ComputeNormalsParams(),
                               seed_params=SeedsFromPlaneSupportParams(),
                               planar_config=PlanarRegionConfig(),
                               cluster_config=ClusterRegionConfig(),
                               max_attempts: int = 64,
                               axis: str = "space"):
    """jitted (points [H, W, 3], sensor_origin [3]) -> ShardedStepResult.

    The full device forward — normals, seed ranking, planar growth,
    euclidean clustering — sharded over grid columns on ``mesh``.
    Growth uses the production batched grower
    (sharded_grow_planar_regions_batched) when
    ``planar_config.growth_mode == 'batched'``; the sequential wavefront
    (sharded_grow_planar_regions) remains as the step-by-step parity
    reference for other modes.
    """
    n = mesh.shape[axis]

    def step(points_local, sensor_origin):
        h = points_local.shape[0]
        w_local = points_local.shape[1]
        w = w_local * n

        nrm = sharded_normals(points_local, sensor_origin, normals_params,
                              axis)
        seed_idx, seed_valid = sharded_plane_support_seeds(
            points_local, nrm, seed_params, h, w, axis)
        labels0 = jnp.full((h, w_local), UNLABELED, jnp.int32)
        if planar_config.growth_mode == "batched":
            rank_grid = sharded_plane_support_rank_grid(
                points_local, nrm, seed_params, h, w, axis)
            regions = sharded_grow_planar_regions_batched(
                points_local, nrm, labels0, seed_idx, seed_valid,
                planar_config, h, w, axis, 0, seed_rank_grid=rank_grid)
        else:
            regions = sharded_grow_planar_regions(
                points_local, nrm, labels0, seed_idx, seed_valid,
                planar_config, h, w, axis, 0, max_attempts)

        eligible = (regions.labels == UNLABELED) \
            & nansafe.all_finite(points_local)
        roots = sharded_connected_components(
            points_local, eligible,
            jnp.asarray(cluster_config.squared_distance_threshold,
                        points_local.dtype),
            cluster_config.half_search_window, h, w, axis)

        # Cluster id assignment WITHOUT gathering any full grid: component
        # sizes reduce locally by global root index and merge with ONE psum
        # of the [H*W] size table (roots are global col-major indices, so
        # each component's members sum across shards exactly). The dense-id
        # table (cumsum over accepted roots) is replicated compute on the
        # psum'd vector; labels/normals stay column-sharded — the previous
        # formulation all-gathered roots/eligibility/labels/normals and
        # re-reduced the full grid on EVERY shard, the dominant
        # duplicated-work term in the strong-scaling sweep (VERDICT r4 #6).
        sizes_local = jax.ops.segment_sum(
            eligible.astype(jnp.int32).reshape(-1),
            roots.reshape(-1), num_segments=h * w + 1)[:h * w]
        sizes = lax.psum(sizes_local, axis)
        accepted = sizes >= cluster_config.min_region_inliers
        # dense ids by ascending root index (earliest-seed order when every
        # point seeds in ascending col-major order)
        order = jnp.cumsum(accepted.astype(jnp.int32)) - 1
        roots_safe = jnp.clip(roots, 0, h * w - 1)
        cluster_id = jnp.where(
            (roots < h * w) & eligible & accepted[roots_safe],
            order[roots_safe], -1)
        num_clusters = jnp.sum(accepted.astype(jnp.int32))

        combined = jnp.where(cluster_id >= 0,
                             cluster_id + regions.num_regions,
                             regions.labels)
        # region table stays replicated (psum-derived) except the label
        # grid, which the out_specs assemble from the column shards
        return ShardedStepResult(labels=combined, normals=nrm,
                                 planar=regions,
                                 num_clusters=num_clusters)

    planar_spec = planar_model.PlanarRegions(
        labels=P(None, axis), num_regions=P(), planes=P(), centroids=P(),
        curvatures=P(), counts=P(), seed_indices=P(),
        moments=plane_fit.PlaneMoments(s2=P(), s1=P(), w=P(),
                                       normal_hint=P()),
        overflow=P())
    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(None, axis, None), P()),
        out_specs=ShardedStepResult(
            labels=P(None, axis), normals=P(None, axis, None),
            planar=planar_spec, num_clusters=P()),
        check_vma=False)
    return jax.jit(sharded)
