"""Batched planar region growing — all regions concurrently.

The sequential driver (models/planar.py) replicates the reference's
seed-by-seed semantics but serializes across regions; on an accelerator
every data-dependent loop iteration costs fixed overhead, so the production
path grows **all regions at once** (the "batched variant" of SURVEY.md §7
step 5):

  * K = max_regions slots; each holds a founder seed, its pop-priority
    rank, a plane, a sticky orientation hint, and a member mask.
  * Stage A: generations of gated 4-neighborhood ring dilation with
    per-generation conflict resolution and 30-inlier-cadence refits —
    emulating the reference's BFS-with-evolving-plane dynamics where they
    decide growth basins.
  * Stage B: scan-based flood-fill closure epochs under the stabilized
    planes; dead slots are reassigned to the best still-uncovered seeds
    each step, so regions hidden behind a dominant plane (walls behind the
    floor's seed crowd) are discovered as coverage grows.

See grow_planar_regions_batched's docstring for the full semantics map to
segmentation.h/planar_region.h. Agreement with the sequential reference
semantics is empirical (validated >=99% on the parity suites); dense ids
are assigned in rank order, which equals the sequential acceptance order
whenever regions are disjoint. The same core runs column-sharded on a
device mesh through the GrowerBackend hooks (parallel/sharded.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as _np

from pcseg_tpu.models.config import UNLABELED, PlanarRegionConfig
from pcseg_tpu.models.planar import PlanarRegions
from pcseg_tpu.ops import geom, nansafe, plane_fit


def _shift_mask(arr, dr, dc, fill=False):
    """Shift the last two axes: out[..., r, c] = arr[..., r+dr, c+dc]."""
    h, w = arr.shape[-2], arr.shape[-1]
    out = jnp.full_like(arr, fill)
    if abs(dr) >= h or abs(dc) >= w:
        return out
    rs_src = slice(max(0, dr), h + min(0, dr))
    cs_src = slice(max(0, dc), w + min(0, dc))
    rs_dst = slice(max(0, -dr), h + min(0, -dr))
    cs_dst = slice(max(0, -dc), w + min(0, -dc))
    return out.at[..., rs_dst, cs_dst].set(arr[..., rs_src, cs_src])


def _pack_bits(masks):
    """[K, H, W] bool -> [ceil(K/32), H, W] uint32 bit-planes (bit k%32 of
    word k//32 = slot k). The slot axis rides in the bits so every flood
    op touches 32x less HBM than the unpacked bool tensor."""
    k, h, w = masks.shape
    nw = (k + 31) // 32
    pad = nw * 32 - k
    m = masks
    if pad:
        m = jnp.concatenate(
            [m, jnp.zeros((pad, h, w), bool)], axis=0)
    m = m.reshape(nw, 32, h, w).astype(jnp.uint32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(m * weights[None, :, None, None], axis=1,
                   dtype=jnp.uint32)


def _unpack_bits(words, k):
    """[NW, H, W] uint32 -> [K, H, W] bool."""
    nw, h, w = words.shape
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (words[:, None] >> shifts[None, :, None, None]) & jnp.uint32(1)
    return bits.reshape(nw * 32, h, w)[:k].astype(bool)


def _shift_axis(x, d, axis, fill):
    """out[..., j, ...] = x[..., j - d, ...] along ``axis`` (static d; out of
    range -> fill). One pad + one slice — no strided slicing, no scatter,
    and XLA fuses it into the consumer."""
    if d == 0:
        return x
    axis = axis % x.ndim
    n = x.shape[axis]
    if abs(d) >= n:
        return jnp.full_like(x, fill)
    pad = [(0, 0)] * x.ndim
    idx = [slice(None)] * x.ndim
    if d > 0:
        pad[axis] = (d, 0)
        idx[axis] = slice(0, n)
    else:
        pad[axis] = (0, -d)
        idx[axis] = slice(-d, n - d)
    padded = jnp.pad(x, pad, constant_values=x.dtype.type(fill))
    return padded[tuple(idx)]


def _seg_or_scan_packed(v, blocked, axis, reverse, max_run=None):
    """Segmented inclusive OR-scan on packed bit-planes via Hillis-Steele
    shift doubling: per bit, result_j = OR of v_i over the run of unblocked
    elements ending at j (a blocked element keeps only its own v) — exactly
    the (value, reset) monoid of the previous associative_scan formulation,
    computed with log2(n) shifted bitwise steps instead of strided slices.

    ``max_run`` (static) bounds the longest unblocked run the caller can
    produce (e.g. a radius-r seed box caps runs at 2r+1): the doubling stops
    there instead of at the full axis length."""
    n = v.shape[axis]
    if max_run is not None:
        n = min(n, max_run)
    ones = 0xFFFFFFFF
    b = blocked
    d = 1
    while d < n:
        s = -d if reverse else d
        vs = _shift_axis(v, s, axis, 0)
        bs = _shift_axis(b, s, axis, ones)
        v = v | (vs & ~b)
        b = b | bs
        d *= 2
    return v


def _segmented_or_spread_packed(reach, gate_bits, not_gate, axis,
                                max_run=None):
    fwd = _seg_or_scan_packed(reach, not_gate, axis, False, max_run)
    bwd = _seg_or_scan_packed(reach, not_gate, axis, True, max_run)
    return (fwd | bwd) & gate_bits


def flood_fill_static(gate, sources, rounds, max_run=None):
    """Batched segmented-scan flood fill on the last two axes: one round of
    row+column segmented spread per 'turn' of the winding path, iterated to
    the (unique, monotone) fixed point under a while_loop with a ``rounds``
    cap — loop iterations execute on-device, so only the rounds actually
    needed are paid for, and the body compiles once.

    gate/sources: [K, H, W] bool. ``max_run`` (static or None) bounds the
    longest gate-true run along either axis (see _seg_or_scan_packed). The
    K slots are packed into uint32 bit-planes and spread with Hillis-Steele
    shift-doubling scans (32x less HBM traffic than unpacked bools, no
    strided slicing) — bit-identical to the associative_scan formulation
    (tested)."""
    with jax.named_scope("flood"):
        g = _pack_bits(gate)
        not_g = ~g
        reach0 = _pack_bits(sources & gate)

        def one_round(reach):
            reach = _segmented_or_spread_packed(reach, g, not_g, -1, max_run)
            return _segmented_or_spread_packed(reach, g, not_g, -2, max_run)

        def cond(state):
            reach, prev, it = state
            return (it < rounds) & jnp.any(reach != prev)

        def body(state):
            reach, _, it = state
            return one_round(reach), reach, it + 1

        first = one_round(reach0)
        reach, _, _ = jax.lax.while_loop(cond, body,
                                         (first, reach0, jnp.int32(1)))
        return _unpack_bits(reach, gate.shape[0])


class _Slots(NamedTuple):
    seed_idx: jnp.ndarray   # [K] col-major seed index
    rank: jnp.ndarray       # [K] pop priority (smaller = earlier popped)
    alive: jnp.ndarray      # [K]
    plane: jnp.ndarray      # [K, 4]
    hint: jnp.ndarray       # [K, 3] sticky normal orientation
    members: jnp.ndarray    # [K, H, W]
    fit_count: jnp.ndarray = None  # [K] member count at the last refit


# Rank sentinel for "not a seed" / dead slot. Strictly below int32 max so
# arithmetic on ranks can't overflow; all real ranks (including the negative
# ranks of appended temporal seeds) are far below it.
INF_RANK = _np.int32(2**30)


def rank_grid_from_seed_vector(seed_indices, seed_valid, h, w,
                               w_local=None, col0=0):
    """[H, W_local] int32 pop-rank grid from a ranked seed *vector* (the
    driver pops back-to-front, so the LAST entry gets the best = smallest
    rank). Temporal seeds are appended to the vector before ranking
    (planar_region.h:516 appends, so appended seeds pop first).

    ``w`` is the GLOBAL column count; ``w_local``/``col0`` carve out a
    column shard (defaults: the whole grid)."""
    w_local = w if w_local is None else w_local
    s = seed_indices.shape[0]
    rank = (s - 1) - jnp.arange(s, dtype=jnp.int32)
    ok = seed_valid & (seed_indices >= 0) & (seed_indices < h * w)
    r = seed_indices % h
    c_local = seed_indices // h - col0
    owned = ok & (c_local >= 0) & (c_local < w_local)
    flat_cm = jnp.full((h * w_local,), INF_RANK, jnp.int32)
    flat_cm = flat_cm.at[
        jnp.clip(c_local, 0, w_local - 1) * h + r].min(
        jnp.where(owned, rank, INF_RANK))
    return jnp.swapaxes(flat_cm.reshape(w_local, h), 0, 1)


class GrowerBackend:
    """Hooks that differ between the single-device grower and the
    column-sharded one (parallel/sharded.py). The algorithm itself lives in
    :func:`grow_planar_regions_batched` ONCE, parameterized by these —
    single-chip and multi-chip cannot diverge.

    Members/masks are [K, H, W_local]; all slot tables are replicated.
    """

    w_total = None   # global column count
    col0 = 0         # global col index of local col 0 (traced when sharded)

    def psum(self, x):
        """Sum a replicated-shape value across shards."""
        return x

    def pmin(self, x):
        return x

    def pmax(self, x):
        return x

    def flood(self, gate, src, rounds):
        """Connected flood of src through gate (bool [K, H, W_local]),
        across shard boundaries when sharded."""
        return flood_fill_static(gate, src, rounds)

    def dilate_rings(self, members, gate, n):
        """n rings of gated 4-neighborhood dilation (bool [K, H, W_local]),
        crossing shard boundaries when sharded."""
        g = _pack_bits(gate)
        m = _pack_bits(members & gate)
        for _ in range(n):
            nb = (_shift_axis(m, 1, -1, 0) | _shift_axis(m, -1, -1, 0)
                  | _shift_axis(m, 1, -2, 0) | _shift_axis(m, -1, -2, 0))
            m = m | (nb & g)
        return _unpack_bits(m, members.shape[0])

    def dilate4(self, members):
        """Ungated 1-ring 4-neighborhood dilation (for adjacency tests)."""
        return (members
                | _shift_mask(members, 1, 0) | _shift_mask(members, -1, 0)
                | _shift_mask(members, 0, 1) | _shift_mask(members, 0, -1))

    def gather_cells(self, points, normals, lin_idx):
        """(points [K, 3], normals [K, 3]) at global col-major ``lin_idx``."""
        h = points.shape[0]
        r = lin_idx % h
        c = jnp.clip(lin_idx // h, 0, points.shape[1] - 1)
        return points[r, c], normals[r, c]


def grow_planar_regions_batched(
        points: jnp.ndarray,
        normals: jnp.ndarray,
        labels: jnp.ndarray,
        seed_indices: jnp.ndarray,
        seed_valid: jnp.ndarray,
        config: PlanarRegionConfig = PlanarRegionConfig(),
        initial_id_offset: int = 0,
        # 13 generations of 2 rings: the total stage-A span (26 rings) and
        # final labels match the original 26x1 schedule (bit-identical on
        # the 560x560 parity scene and the room scenes; 0.9995 agreement
        # on the cluttered fixture) at HALF the per-generation
        # refit/conflict overhead — stage A was ~70% of grow's runtime.
        # Override with PCSEG_STAGE_A="gens/rings".
        stage_a_gens: int = 13,
        stage_a_rings: int = 2,
        closure_epochs: int = 2,
        seed_rank_grid: jnp.ndarray = None,
        flood_rounds: int = 64,
        backend: GrowerBackend = None) -> PlanarRegions:
    """Batched drop-in for grow_planar_regions (same result contract).

    Region identity follows the *rank grid*: every seed cell carries its
    sequential pop rank (the reference's multimap order), a slot's rank is
    the best (minimum) rank among its current members' seed cells, and
    conflicts resolve to the best rank. This makes slot priorities converge
    to the sequential acceptance order regardless of which seed happened to
    found the slot: the reference's region i is founded by the best seed
    not claimed by regions 0..i-1, which is exactly the best seed among its
    own final members (greedy argument) — the quantity the per-epoch rank
    update computes. A slot none of whose members is a seed dissolves (the
    reference never grows a region without a seed inside it) and its cells
    are released for re-claiming.

    Growth happens in two stages that together emulate the sequential
    BFS-with-evolving-plane dynamics (segmentation.h:252-284 +
    planar_region.h:163-184):

      * **Stage A (local generations).** Each generation dilates every
        slot's members by a few 4-neighborhood rings *within the current
        inlier gate*, resolves conflicts, and re-fits. Ring order equals
        BFS order, and with only a handful of cells admitted per
        generation, the refit cadence tracks the reference's
        every-30th-inlier re-estimation closely — including the
        knife-edge case where an attempt seeded on a degenerate (thin
        strip) neighborhood escapes into the true surface only because
        its first ~30-inlier fit does (observed on the room fixtures;
        a fit computed later on the fully-grown strip stays degenerate).
      * **Stage B (closure epochs).** Once the planes have stabilized,
        scan-based flood fill completes each slot to its gate's connected
        fixed point in O(log) passes — the cheap bulk phase.

    Shared rules:

      * The plane refits only while the slot holds at least
        ``plane_model_reestimation_period`` (30) members — the reference
        re-estimates every 30th inlier, so an attempt that never reaches 30
        inliers grows with its *seed plane* for its whole life
        (planar_region.h:172-177). This keeps small nearly-coplanar
        fragments separate exactly like the sequential driver.
      * Membership is monotone within a slot (the reference never
        un-claims an inlier); a cell moves only when a better-ranked slot
        claims it.
      * The orientation hint and seed plane re-anchor to the best-ranked
        member seed cell (the attempt's sequential founder), so the sticky
        normal sign (plane_estimator.cc:113-126) follows the founder's
        normal even when a slot's membership migrates between surfaces.

    Founders: each epoch, every dead slot is (re)assigned the best-ranked
    uncovered seed of a distinct 8x8-tile of the grid (spatial diversity —
    the top of the global ranking is typically a run of adjacent same-count
    seeds on one dominant surface, which would waste the whole slot budget
    on one region per epoch).

    Rejected-attempt quarantine (segmentation.h:277-291) falls out of the
    claims: a slot that fails the host finalize gates keeps *holding* its
    cells through the final claims (denying them to worse-ranked slots,
    exactly the kAlreadyExamedPoint lifecycle) and the host resets them to
    UNLABELED afterwards.
    """
    import os as _os
    # Stage-A schedule override "gens/rings" (trace-time env, like
    # PCSEG_RADII_FACTOR): rings/gen trades refit cadence for generation
    # count at the same total span — parity-gated like the radii factor.
    _sa = _os.environ.get("PCSEG_STAGE_A")
    if _sa:
        stage_a_gens, stage_a_rings = (int(x) for x in _sa.split("/"))
    bk = backend or GrowerBackend()
    h, w = points.shape[0], points.shape[1]   # w = LOCAL column count
    w_total = bk.w_total if bk.w_total is not None else w
    col0 = bk.col0
    hw = h * w
    dtype = points.dtype
    k_cap = config.max_regions
    tau = jnp.asarray(config.max_plane_distance, dtype)
    inf_rank = INF_RANK

    # Eligibility carries the finite-point mask EXPLICITLY, and via the
    # bit-level test (ops/nansafe.py). Mathematically redundant
    # (plane.absDistance(NaN) < tau is false, so the inlier gate could
    # never admit an invalid point, planar_region.h:163-170) — but a
    # compiler that folds NaN comparisons or jnp.isfinite away inside large
    # fused programs (observed on an earlier backend) lets the epochs
    # claim NaN-hole cells at VGA (their zero-substituted moments then tilt
    # the refits and fragment the dominant wall into ~20 bogus regions).
    finite_pts = nansafe.all_finite(points)
    eligible0 = (labels == UNLABELED) & finite_pts

    if seed_rank_grid is None:
        seed_rank_grid = rank_grid_from_seed_vector(
            seed_indices, seed_valid, h, w_total, w_local=w, col0=col0)
    # a usable seed: eligible cell with finite point+normal
    cell_ok = (eligible0
               & nansafe.all_finite(normals))
    rank_grid = jnp.where(cell_ok, seed_rank_grid, inf_rank)

    slots = _Slots(
        seed_idx=jnp.zeros((k_cap,), jnp.int32),
        rank=jnp.full((k_cap,), inf_rank),
        alive=jnp.zeros((k_cap,), bool),
        plane=jnp.zeros((k_cap, 4), dtype),
        hint=jnp.zeros((k_cap, 3), dtype).at[:, 0].set(1.0),
        members=jnp.zeros((k_cap, h, w), bool),
        fit_count=jnp.zeros((k_cap,), jnp.int32),
    )

    def claims_of(members, rank):
        """Resolve conflicts: per pixel, the member slot with min rank.
        Returns (claim_slot [H, W] in [0, K] (K = none), members')."""
        rank_grid = jnp.where(members, rank[:, None, None], inf_rank)
        best = jnp.min(rank_grid, axis=0)
        # slot index achieving the best rank (ranks are unique per slot)
        claim = jnp.argmin(rank_grid, axis=0).astype(jnp.int32)
        claim = jnp.where(best < inf_rank, claim, k_cap)
        new_members = members & (claim[None] ==
                                 jnp.arange(k_cap, dtype=jnp.int32)[:, None,
                                                                    None])
        return claim, new_members

    # --- tile decomposition for founder diversity ---------------------------
    n_tiles_axis = 8
    th = -(-h // n_tiles_axis)          # ceil (GLOBAL grid tiles)
    tw = -(-w_total // n_tiles_axis)
    n_tiles = n_tiles_axis * n_tiles_axis
    big_lin = jnp.int32(2 ** 30)

    rows_l = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols_g = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) + col0
    tid_grid = ((rows_l // th) * n_tiles_axis + cols_g // tw).reshape(-1)
    lin_grid = (cols_g * h + rows_l).reshape(-1)

    hp = n_tiles_axis * th
    wp = n_tiles_axis * tw

    def tile_winners(avail_rank):
        """Per global 8x8 tile, the (rank, col-major index) of its best
        available seed (combined across shards). Returns
        (winner_rank [T], winner_cm_idx [T]), both replicated."""
        if backend is None:
            # Dense path: pad the grid to tile multiples and reduce with a
            # reshape — segment_min lowers to a scatter (and the attainer
            # pass to a full-grid gather); this is two plain reductions.
            def tmin(g, fill):
                gp = jnp.pad(g, ((0, hp - h), (0, wp - w)),
                             constant_values=fill)
                return jnp.min(
                    gp.reshape(n_tiles_axis, th, n_tiles_axis, tw),
                    axis=(1, 3))
            val_t = tmin(avail_rank, inf_rank)               # [8, 8]
            val_b = jnp.broadcast_to(
                val_t[:, None, :, None],
                (n_tiles_axis, th, n_tiles_axis, tw)).reshape(hp, wp)[
                :h, :w]
            idx_t = tmin(jnp.where(avail_rank == val_b,
                                   lin_grid.reshape(h, w), big_lin),
                         big_lin)
            return val_t.reshape(-1), idx_t.reshape(-1)
        flat = avail_rank.reshape(-1)
        val = bk.pmin(jax.ops.segment_min(
            flat, tid_grid, num_segments=n_tiles,
            indices_are_sorted=False))
        # the rank holder is unique (ranks are unique per cell), so the
        # min linear index among attainers is the winner's cell
        idx = bk.pmin(jax.ops.segment_min(
            jnp.where(flat == val[tid_grid], lin_grid, big_lin),
            tid_grid, num_segments=n_tiles))
        return val, idx

    def assign_founders(slots, covered):
        """Fill dead slots: best-ranked uncovered seed per distinct tile."""
        avail_rank = jnp.where(covered, inf_rank, rank_grid)
        cand_rank_t, cand_idx_t = tile_winners(avail_rank)
        order = jnp.argsort(cand_rank_t)       # best tiles first
        cand_rank = cand_rank_t[order]
        cand_idx = cand_idx_t[order]
        # positions of free slots, in slot order
        free = ~slots.alive
        free_pos = jnp.cumsum(free.astype(jnp.int32)) - 1  # idx among free
        take = free & (free_pos < n_tiles)
        pick = jnp.clip(free_pos, 0, n_tiles - 1)
        newly = take & (cand_rank[pick] < inf_rank)
        new_seed = jnp.where(newly, cand_idx[pick], slots.seed_idx)
        new_rank = jnp.where(newly, cand_rank[pick], slots.rank)
        npt, nnm = bk.gather_cells(points, normals, new_seed)
        plane0 = geom.plane_from_normal_point(nnm, npt)
        onehot = local_onehot(new_seed)
        return _Slots(
            seed_idx=new_seed,
            rank=new_rank,
            alive=slots.alive | newly,
            plane=jnp.where(newly[:, None], plane0, slots.plane),
            hint=jnp.where(newly[:, None], nnm, slots.hint),
            members=jnp.where(newly[:, None, None], onehot, slots.members),
            fit_count=jnp.where(newly, 0, slots.fit_count),
        )

    # Per-pixel moment features: one [K, HW] x [HW, 10] matmul per refit
    # does the accumulator reduction as a single contraction.
    pts_safe = nansafe.sanitize(points)
    px, py, pz = pts_safe[..., 0], pts_safe[..., 1], pts_safe[..., 2]
    feat = jnp.stack([px * px, px * py, px * pz, py * py, py * pz, pz * pz,
                      px, py, pz, jnp.ones_like(px)],
                     axis=-1).reshape(hw, 10)

    def refit_moments(slots):
        """Batched plane fit of the current members (one matmul + one
        batched eigensolve); returns (moments, solution) without mutating
        the slot planes — the caller applies the re-estimation cadence."""
        wts = slots.members.astype(dtype).reshape(k_cap, hw)
        sums = bk.psum(jnp.dot(wts, feat,
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST))
        m = plane_fit.PlaneMoments(s2=sums[:, :6], s1=sums[:, 6:9],
                                   w=sums[:, 9], normal_hint=slots.hint)
        return m, plane_fit.solve(m)

    period = int(config.plane_model_reestimation_period)

    def local_onehot(lin_idx):
        """[K, H, W_local] one-hot of global col-major cells (False on
        shards that don't own them)."""
        sr = lin_idx % h
        sc = jnp.clip(lin_idx // h, 0, w_total - 1) - col0
        owned = (sc >= 0) & (sc < w)
        return (jnp.zeros((k_cap, h, w), bool)
                .at[jnp.arange(k_cap), sr, jnp.clip(sc, 0, w - 1)]
                .set(owned))

    def anchor_onehot(slots):
        return local_onehot(slots.seed_idx)

    def prelude(slots, assign, debug_tag=None):
        """Founder assignment + conflict resolution + the per-slot inlier
        gate; better-ranked claims (from the previous settled state) are
        excluded from worse slots' gates — the sequential driver ran those
        attempts first."""
        covered = jnp.any(slots.members, axis=0)
        if assign:
            slots = assign_founders(slots, covered)
        if debug_tag is not None:
            import os as _os
            track = _os.environ.get("PCSEG_DEBUG_TRACK")
            if track is None:
                jax.debug.print(
                    debug_tag + " ranks={r} alive={a} counts={c}",
                    r=slots.rank[:8], a=slots.alive[:8],
                    c=jnp.sum(slots.members.astype(jnp.int32),
                              axis=(1, 2))[:8])
            else:
                sel = slots.seed_idx == int(track)
                cnt = jnp.sum(slots.members.astype(jnp.int32), axis=(1, 2))
                k_t = jnp.argmax(sel)
                jax.debug.print(
                    debug_tag + " track found={f} slot={k} rank={r} "
                    "count={c} fitc={fc} plane={p}",
                    f=jnp.any(sel), k=k_t, r=slots.rank[k_t],
                    c=cnt[k_t], fc=slots.fit_count[k_t],
                    p=slots.plane[k_t])
        # members are pairwise disjoint here (settle claims-trims them and
        # founders land on uncovered cells), so the per-pixel claim rank is
        # a plain min-reduce — no argmin / re-trim needed
        members = slots.members
        claim_rank = jnp.min(
            jnp.where(members, slots.rank[:, None, None], inf_rank), axis=0)
        dist = jnp.abs(
            jnp.einsum("kc,hwc->khw", slots.plane[:, :3], points,
                       precision=jax.lax.Precision.HIGHEST)
            + slots.plane[:, 3][:, None, None])
        gate = (dist < tau) & eligible0[None] \
            & (claim_rank[None] >= slots.rank[:, None, None]) \
            & slots.alive[:, None, None]
        # membership is monotone (the reference never un-claims an inlier):
        # current members always conduct and stay reachable
        gate = gate | members
        return slots, members, gate

    def generation(slots, assign=True, debug_tag=None):
        """Stage A: dilate by ``stage_a_rings`` 4-neighborhood rings within
        the gate (ring order == BFS order), then refit. Runs on packed
        bit-planes."""
        slots, members, gate = prelude(slots, assign, debug_tag)
        reach = bk.dilate_rings(members | anchor_onehot(slots), gate,
                                stage_a_rings)
        return settle(slots, reach)

    rows_l2 = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)

    def seed_box(slots, radius):
        """[K, H, W_local] Chebyshev box of ``radius`` around each slot's
        anchor (None = whole grid), in GLOBAL coordinates."""
        if radius is None:
            return jnp.ones((k_cap, h, w), bool)
        sr = slots.seed_idx % h
        sc = jnp.clip(slots.seed_idx // h, 0, w_total - 1)
        return ((jnp.abs(rows_l2[None] - sr[:, None, None]) <= radius)
                & (jnp.abs(cols_g.reshape(h, w)[None]
                           - sc[:, None, None]) <= radius))

    def epoch(slots, assign, rounds, radius=None, debug_tag=None):
        """Stage B: scan-flood from the anchor to the gate's connected
        fixed point, optionally within a Chebyshev box of ``radius``
        around the anchor — the closure epochs grow the box geometrically
        with a refit between each (the reference's every-30th-inlier fit
        keeps adapting while its wavefront advances; flooding a 10^4-cell
        basin under one frozen plane loses the fit's drift and measurably
        reshapes quantization-noise regions at long range). Flooding from
        the anchor (members conduct via the gate) prunes members a
        better-ranked slot's claims disconnected from the anchor — the
        sequential attempt, run later in full, would never have crossed
        the stolen corridor."""
        slots, members, gate = prelude(slots, assign, debug_tag)
        gate = gate & (seed_box(slots, radius) | members)
        reach = bk.flood(gate, anchor_onehot(slots), rounds)
        return settle(slots, reach)

    def settle(slots, new_members):
        _, new_members = claims_of(new_members, slots.rank)
        counts = bk.psum(jnp.sum(new_members.astype(jnp.int32),
                                 axis=(1, 2)))
        # Rank update: slot rank := best seed rank among current members.
        # A slot that holds no seed cell at all dissolves and releases its
        # cells (the reference never grows a region without a seed in it;
        # a slot whose founding seed was claimed by a better-ranked region
        # continues as the best *remaining* seed inside it — exactly the
        # seed the sequential driver would pop for those cells next).
        masked_rank = jnp.where(new_members, rank_grid[None], inf_rank)
        local_min = jnp.min(masked_rank, axis=(1, 2))
        member_rank = bk.pmin(local_min)
        alive = slots.alive & (counts > 0) & (member_rank < inf_rank)
        # re-anchor to the best-ranked member seed — the attempt's
        # sequential founder; its normal re-anchors the sticky orientation
        # and its (normal, point) is the attempt's init plane
        best_flat = jnp.argmin(
            masked_rank.reshape(k_cap, hw), axis=1).astype(jnp.int32)
        br = best_flat // w
        bc = best_flat % w
        # the rank holder is unique, so exactly one shard attains the
        # global min; non-owners contribute an out-of-range sentinel
        cand_lin = jnp.where(
            (local_min == member_rank) & (member_rank < inf_rank),
            (bc + col0) * h + br, jnp.int32(2 ** 30))
        anchor_lin = bk.pmin(cand_lin)
        new_seed_idx = jnp.where(alive, anchor_lin, slots.seed_idx)
        # the hint only re-anchors when the founder seed changed (the slot
        # is now a different sequential attempt); otherwise it stays the
        # sticky last-valid normal (plane_estimator.cc:113-126)
        anchor_changed = alive & (new_seed_idx != slots.seed_idx)
        a_pt, a_nm = bk.gather_cells(points, normals, new_seed_idx)
        anchor_n = jnp.where(anchor_changed[:, None], a_nm, slots.hint)
        anchor_p = a_pt
        seed_plane = geom.plane_from_normal_point(anchor_n, anchor_p)
        slots = slots._replace(
            members=new_members & alive[:, None, None],
            alive=alive,
            rank=jnp.where(alive, member_rank, inf_rank),
            seed_idx=new_seed_idx,
            hint=anchor_n,
            plane=jnp.where(anchor_changed[:, None], seed_plane,
                            slots.plane),
            fit_count=jnp.where(anchor_changed, 0, slots.fit_count))
        _, sol = refit_moments(slots)
        # The reference re-estimates when the inlier count crosses a
        # multiple of ``plane_model_reestimation_period`` (30)
        # (planar_region.h:172-177): an attempt that never reaches 30
        # inliers grows with its seed plane for its whole life, and the
        # fit the growth uses is always one computed at a crossing —
        # knife-edge degenerate fits (thin strips) depend on the exact
        # crossing-time member set, so refits happen ONLY at crossings.
        # A degenerate fit at a crossing keeps the previous (sticky)
        # normal recentered on the member centroid
        # (plane_estimator.cc:224-227).
        crossing = alive & ((counts // period) > (slots.fit_count // period))
        recentered = geom.plane_from_normal_point(slots.hint, sol.centroid)
        fit_plane = jnp.where(sol.valid[:, None], sol.plane, recentered)
        new_plane = jnp.where(crossing[:, None], fit_plane, slots.plane)
        new_hint = jnp.where((crossing & sol.valid)[:, None],
                             sol.normal, slots.hint)
        return slots._replace(
            plane=new_plane, hint=new_hint,
            fit_count=jnp.where(crossing, counts, slots.fit_count))

    # --- patch-mode stage A --------------------------------------------------
    # Stage-A membership lives inside ball(founding anchor, span), so on
    # large grids every per-generation tensor can be a [K, P, P] patch
    # instead of [K, H, W] — ~(H*W)/P^2 less compute and HBM traffic (80x
    # at VGA). Cross-slot claims stay exact through a global owner-rank
    # grid maintained with per-slot window min-stamps (64 dynamic slices,
    # no scatters). Results match the full-grid generations up to f32
    # moment-sum reduction order (same tolerance class as the reference's
    # own accumulation-order sensitivity, plane_estimator_test.cc:34-36).
    patch = 64
    span = stage_a_gens * stage_a_rings
    use_patches = (backend is None and h >= patch and w >= patch
                   and h * w >= 4 * patch * patch
                   and patch // 2 - span - stage_a_rings >= 1
                   # debug/ops escape hatch (miscompile bisection)
                   and _os.environ.get("PCSEG_STAGEA") != "full")

    def stage_a_patched(slots):
        kar = jnp.arange(k_cap, dtype=jnp.int32)
        half = patch // 2

        def stamp_owner(orr, orc, mem_p, rank, alive):
            owner = jnp.full((h, w), inf_rank, jnp.int32)

            def body(k, owner):
                win = jax.lax.dynamic_slice(owner, (orr[k], orc[k]),
                                            (patch, patch))
                vals = jnp.where(mem_p[k] & alive[k], rank[k], inf_rank)
                return jax.lax.dynamic_update_slice(
                    owner, jnp.minimum(win, vals), (orr[k], orc[k]))

            return jax.lax.fori_loop(0, k_cap, body, owner)

        def gather(grid, orr, orc):
            def one(r0, c0):
                if grid.ndim == 2:
                    return jax.lax.dynamic_slice(grid, (r0, c0),
                                                 (patch, patch))
                return jax.lax.dynamic_slice(
                    grid, (r0, c0, 0), (patch, patch, grid.shape[2]))
            return jax.vmap(one)(orr, orc)

        def gen_body(i, st):
            # in-loop optimization barrier: the patched stage A was once
            # observed miscompiled when fused into the full pipeline (exact
            # in truncated programs; full-grid stage A in the same program
            # exact) — pin the generation boundary
            slots, orr, orc, mem_p = jax.lax.optimization_barrier(st)
            owner = stamp_owner(orr, orc, mem_p, slots.rank, slots.alive)
            covered = owner < inf_rank
            # founder assignment (assign_founders minus the member grids)
            avail_rank = jnp.where(covered, inf_rank, rank_grid)
            cand_rank_t, cand_idx_t = tile_winners(avail_rank)
            order = jnp.argsort(cand_rank_t)
            cand_rank = cand_rank_t[order]
            cand_idx = cand_idx_t[order]
            free = ~slots.alive
            free_pos = jnp.cumsum(free.astype(jnp.int32)) - 1
            take = free & (free_pos < n_tiles)
            pick = jnp.clip(free_pos, 0, n_tiles - 1)
            newly = take & (cand_rank[pick] < inf_rank)
            new_seed = jnp.where(newly, cand_idx[pick], slots.seed_idx)
            nr = new_seed % h
            nc = jnp.clip(new_seed // h, 0, w - 1)
            npt = points[nr, nc]
            nnm = normals[nr, nc]
            plane0 = geom.plane_from_normal_point(nnm, npt)
            new_or = jnp.clip(nr - half, 0, h - patch)
            new_oc = jnp.clip(nc - half, 0, w - patch)
            orr = jnp.where(newly, new_or, orr)
            orc = jnp.where(newly, new_oc, orc)
            onehot = (jnp.zeros((k_cap, patch, patch), bool)
                      .at[kar, nr - orr, nc - orc].max(newly))
            mem_p = jnp.where(newly[:, None, None], onehot, mem_p)
            slots = slots._replace(
                seed_idx=new_seed,
                rank=jnp.where(newly, cand_rank[pick], slots.rank),
                alive=slots.alive | newly,
                plane=jnp.where(newly[:, None], plane0, slots.plane),
                hint=jnp.where(newly[:, None], nnm, slots.hint),
                fit_count=jnp.where(newly, 0, slots.fit_count))

            pts_p = gather(points, orr, orc)           # [K, P, P, 3]
            elig_p = gather(eligible0, orr, orc)
            rank_p = gather(rank_grid, orr, orc)
            owner_p = gather(owner, orr, orc)

            dist = jnp.abs(
                jnp.einsum("kc,kpqc->kpq", slots.plane[:, :3], pts_p,
                           precision=jax.lax.Precision.HIGHEST)
                + slots.plane[:, 3][:, None, None])
            gate = (dist < tau) & elig_p \
                & (owner_p >= slots.rank[:, None, None]) \
                & slots.alive[:, None, None]
            gate = gate | mem_p

            ar = slots.seed_idx % h - orr
            ac = jnp.clip(slots.seed_idx // h, 0, w - 1) - orc
            a_ok = (ar >= 0) & (ar < patch) & (ac >= 0) & (ac < patch)
            aoh = (jnp.zeros((k_cap, patch, patch), bool)
                   .at[kar, jnp.clip(ar, 0, patch - 1),
                       jnp.clip(ac, 0, patch - 1)].max(a_ok))
            m = mem_p | (aoh & gate)
            for _ in range(stage_a_rings):
                nb = (_shift_mask(m, 1, 0) | _shift_mask(m, -1, 0)
                      | _shift_mask(m, 0, 1) | _shift_mask(m, 0, -1))
                m = m | (nb & gate)

            # claims: re-stamp with the grown members, prune losers
            owner2 = stamp_owner(orr, orc, m, slots.rank, slots.alive)
            owner2_p = gather(owner2, orr, orc)
            new_mem = m & (owner2_p == slots.rank[:, None, None])

            counts = jnp.sum(new_mem.astype(jnp.int32), axis=(1, 2))
            masked_rank = jnp.where(new_mem, rank_p, inf_rank)
            member_rank = jnp.min(masked_rank, axis=(1, 2))
            alive = slots.alive & (counts > 0) & (member_rank < inf_rank)
            best_flat = jnp.argmin(
                masked_rank.reshape(k_cap, patch * patch),
                axis=1).astype(jnp.int32)
            br = orr + best_flat // patch
            bc = orc + best_flat % patch
            new_seed_idx = jnp.where(alive, bc * h + br, slots.seed_idx)
            anchor_changed = alive & (new_seed_idx != slots.seed_idx)
            a_nm = jnp.where(anchor_changed[:, None],
                             normals[br, bc], slots.hint)
            seed_plane = geom.plane_from_normal_point(a_nm, points[br, bc])
            slots = slots._replace(
                alive=alive,
                rank=jnp.where(alive, member_rank, inf_rank),
                seed_idx=new_seed_idx,
                hint=a_nm,
                plane=jnp.where(anchor_changed[:, None], seed_plane,
                                slots.plane),
                fit_count=jnp.where(anchor_changed, 0, slots.fit_count))
            new_mem = new_mem & alive[:, None, None]

            # patch-local refit + re-estimation cadence (see settle)
            pp = nansafe.sanitize(pts_p)
            qx, qy, qz = pp[..., 0], pp[..., 1], pp[..., 2]
            feat_p = jnp.stack(
                [qx * qx, qx * qy, qx * qz, qy * qy, qy * qz, qz * qz,
                 qx, qy, qz, jnp.ones_like(qx)],
                axis=-1).reshape(k_cap, patch * patch, 10)
            wts = new_mem.reshape(k_cap, 1, patch * patch).astype(dtype)
            sums = jnp.matmul(wts, feat_p,
                              preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST)[:, 0]
            mom = plane_fit.PlaneMoments(
                s2=sums[:, :6], s1=sums[:, 6:9], w=sums[:, 9],
                normal_hint=slots.hint)
            sol = plane_fit.solve(mom)
            crossing = alive & ((counts // period)
                                > (slots.fit_count // period))
            recentered = geom.plane_from_normal_point(slots.hint,
                                                      sol.centroid)
            fit_plane = jnp.where(sol.valid[:, None], sol.plane, recentered)
            slots = slots._replace(
                plane=jnp.where(crossing[:, None], fit_plane, slots.plane),
                hint=jnp.where((crossing & sol.valid)[:, None],
                               sol.normal, slots.hint),
                fit_count=jnp.where(crossing, counts, slots.fit_count))
            return slots, orr, orc, new_mem

        st0 = (slots,
               jnp.zeros((k_cap,), jnp.int32),
               jnp.zeros((k_cap,), jnp.int32),
               jnp.zeros((k_cap, patch, patch), bool))
        slots, orr, orc, mem_p = jax.lax.fori_loop(
            0, stage_a_gens, gen_body, st0)

        members = jnp.zeros((k_cap, h, w), bool)

        def put(k, members):
            return jax.lax.dynamic_update_slice(
                members, (mem_p[k] & slots.alive[k])[None],
                (k, orr[k], orc[k]))

        members = jax.lax.fori_loop(0, k_cap, put, members)
        return slots._replace(members=members)

    import os
    dbg = os.environ.get("PCSEG_DEBUG_BATCHED") == "1"
    _skip = os.environ.get("PCSEG_GROW_SKIP", "")  # profiling knob
    if _skip:
        # read at TRACE time: a long-lived process with this set silently
        # produces placeholder results from every jitted call — shout
        import warnings
        warnings.warn(
            f"PCSEG_GROW_SKIP={_skip!r}: grower stages skipped — profiling "
            "output only, NOT valid segmentation results", stacklevel=2)
    # Stage A: local ring growth with per-generation refits — the plane's
    # early evolution (which decides growth basins) tracks the reference's
    # every-30th-inlier cadence. Stage B: scan-flood closure epochs with
    # the stabilized planes; the final epoch floods every slot to its
    # gate's fixed point (same-surface slot fragments collapse there: the
    # best-ranked slot's flood covers the whole surface and the claims
    # dissolve the rest).
    radius = 2 * stage_a_gens * stage_a_rings
    radii = []
    # Box growth factor between refits (numerator/denominator): the boxed
    # epochs emulate the sequential fit's drift while its wavefront
    # advances, and VGA parity is MONOTONE in the schedule's fineness
    # (560x560 room scene: 2/1 -> 0.9761, 3/2 -> 0.9875, 4/3 -> 0.9940,
    # 5/4 -> 0.9951, 6/5 -> 0.9972 agreement) — the dominant residual is
    # one region's fit tilting ~0.4 deg away from the sequential
    # trajectory when refits are coarse, which flips a tau-band
    # connectivity knife edge on the far wall. Default 4/3: the cheapest
    # schedule that clears the >=99% north-star gate (PARITY_VGA.json is
    # regenerated at this setting).
    _fac = os.environ.get("PCSEG_RADII_FACTOR", "4/3").split("/")
    _fnum, _fden = int(_fac[0]), int(_fac[1])
    while radius < max(h, w_total):
        radii.append(radius)
        radius = (radius * _fnum) // _fden
    # closure epochs + the final epoch run unboxed (radius covers the grid)
    radii += [max(h, w_total)] * (closure_epochs + 1)
    if dbg:
        for e in range(stage_a_gens):
            slots = generation(slots, assign=True, debug_tag=f"gen{e}")
        for e, r_ in enumerate(radii):
            slots = epoch(slots, assign=True, rounds=flood_rounds,
                          radius=r_, debug_tag=f"box{e}")
    else:
        # every generation (and every epoch) shares one compiled body —
        # fori_loop keeps the XLA program O(1) in the schedule length
        # (the unrolled form took minutes to compile)
        with jax.named_scope("stage_a"):
            if "stagea" in _skip:
                pass
            elif use_patches:
                slots = stage_a_patched(slots)
            else:
                slots = jax.lax.fori_loop(
                    0, stage_a_gens, lambda i, s: generation(s, assign=True),
                    slots)
        # optimization_barrier between the grower stages: the composed
        # program was once observed miscomputed at VGA scale (regions
        # claiming cells far outside their tau-band, full-row member
        # artifacts) while every stage verified exact both in isolation
        # and in programs truncated after that stage — a cross-stage fusion
        # miscompile on an earlier backend. The barrier pins the stage
        # boundary until parity on the GPU shows it can go.
        slots = jax.lax.optimization_barrier(slots)
        if "epochs" in _skip:
            pass
        else:
            radii_arr = jnp.asarray(radii, jnp.int32)
            n_ep = len(radii)
            first_full = next((j for j, r_ in enumerate(radii)
                               if r_ >= max(h, w_total)), n_ep - 1)

            # convergence gate: stop once an UNBOXED epoch (box covers the
            # grid) leaves every slot's member set unchanged — nothing can
            # change after that (unchanged members => unchanged counts,
            # ranks and planes, and founder assignment is deterministic on
            # the covered set; a new founder always adds a member, so
            # "unchanged" also certifies no assignable seed remains).
            # Boxed epochs never stop early: a bigger box next epoch can
            # still admit growth. The psum keeps the sharded while cond in
            # lockstep.
            def ep_cond(st):
                s_, i, stable = st
                return jnp.logical_and(i < n_ep, jnp.logical_not(stable))

            def ep_body(st):
                s_, i, _ = st
                prev = s_.members
                s_ = epoch(s_, assign=True, rounds=flood_rounds,
                           radius=radii_arr[i])
                unchanged = bk.psum(
                    jnp.sum((s_.members != prev).astype(jnp.int32))) == 0
                stable = jnp.logical_and(unchanged, i >= first_full)
                return s_, i + 1, stable

            with jax.named_scope("closure_epochs"):
                slots, _, _ = jax.lax.while_loop(
                    ep_cond, ep_body,
                    (slots, jnp.int32(0), jnp.asarray(False)))

    # Degenerate-attempt resolution. An attempt seeded on a thin (near
    # collinear) neighborhood has a rank-deficient fit: the reference's
    # every-30th-inlier re-estimation then either stays invalid (attempt
    # stalls on its seed plane; finalize rejects it — quarantine) or goes
    # *barely* valid through f32 rounding noise, in which case the
    # extracted eigenvector "escapes" toward the true local surface and
    # the attempt merges into it (observed on the room fixtures; which of
    # the two happens is decided below the reference's own 1e-4
    # accumulation-noise tolerance, plane_estimator_test.cc:34-36). The
    # batched equivalent: a slot whose FINAL member set is rank-deficient
    # (lambda_1 below a small fraction of the trace — a line, not a
    # surface; which side of the escape/stall knife edge such an attempt
    # lands on in the reference is decided by reduction-order noise)
    # dissolves into the best-ranked adjacent surface slot whose plane
    # covers >=90% of its members (the escape outcome); if no such slot
    # exists it stays and the finalize gates reject it (the stall
    # outcome, = quarantine).
    slots = jax.lax.optimization_barrier(slots)  # see stage barrier above
    if "tail" in _skip:
        return PlanarRegions(
            labels=labels, num_regions=jnp.int32(0),
            planes=slots.plane, centroids=slots.plane[:, :3],
            curvatures=slots.rank.astype(points.dtype),
            counts=slots.rank, seed_indices=slots.seed_idx,
            moments=plane_fit.PlaneMoments(
                s2=jnp.zeros((k_cap, 6), points.dtype),
                s1=jnp.zeros((k_cap, 3), points.dtype),
                w=jnp.zeros((k_cap,), points.dtype),
                normal_hint=slots.hint),
            overflow=jnp.any(slots.members))
    _, sol_r = refit_moments(slots)
    robust = slots.alive & sol_r.valid & (sol_r.mid_ratio >= 3e-3)
    dtype_ = points.dtype
    mem_f = slots.members.astype(dtype_).reshape(k_cap, hw)
    counts_f = jnp.maximum(bk.psum(jnp.sum(mem_f, axis=1)), 1.0)
    dil = bk.dilate4(slots.members)
    adj = bk.psum(jnp.dot(dil.reshape(k_cap, hw).astype(dtype_), mem_f.T,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)) > 0
    dist_all = jnp.abs(
        jnp.einsum("kc,hwc->khw", slots.plane[:, :3], points,
                   precision=jax.lax.Precision.HIGHEST)
        + slots.plane[:, 3][:, None, None])
    band = (dist_all < tau).reshape(k_cap, hw).astype(dtype_)
    # cover[l, w] = fraction of loser l's members within tau of winner
    # w's plane
    cover = bk.psum(jnp.dot(
        mem_f, band.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)) / counts_f[:, None]
    loser = slots.alive & ~robust
    winner_ok = robust
    pair = (loser[:, None] & winner_ok[None, :] & adj
            & (cover >= 0.9))
    win = jnp.argmin(jnp.where(pair, slots.rank[None, :], inf_rank),
                     axis=1).astype(jnp.int32)
    has_win = jnp.any(pair, axis=1)
    # losers' members transfer to their winner; losers die
    transfer = (win[None, :] == jnp.arange(k_cap, dtype=jnp.int32)[:, None])
    gained = jnp.einsum(
        "ak,kxy->axy",
        (transfer & has_win[None, :]).astype(dtype_),
        slots.members.astype(dtype_),
        precision=jax.lax.Precision.HIGHEST) > 0
    slots = slots._replace(
        members=jnp.where(winner_ok[:, None, None],
                          slots.members | gained, slots.members)
        & ~(loser & has_win)[:, None, None],
        alive=slots.alive & ~(loser & has_win))

    # final conflict-free claims + acceptance
    claim, members = claims_of(slots.members, slots.rank)
    counts = bk.psum(jnp.sum(members.astype(jnp.int32), axis=(1, 2)))
    accepted = slots.alive & (counts >= config.min_region_inliers)

    # dense ids in rank order among accepted
    order = jnp.argsort(jnp.where(accepted, slots.rank, inf_rank))
    dense = jnp.cumsum(accepted[order].astype(jnp.int32)) - 1
    slot_id = jnp.full((k_cap,), -1, jnp.int32).at[order].set(
        jnp.where(accepted[order], dense, -1))
    num_regions = jnp.sum(accepted.astype(jnp.int32))

    claim_id = jnp.where(claim < k_cap,
                         slot_id[jnp.clip(claim, 0, k_cap - 1)], -1)
    new_labels = jnp.where(claim_id >= 0, claim_id + initial_id_offset,
                           labels)

    # region table in dense-id order. CheckAndFinalize recomputes the plane
    # from the estimator unconditionally (planar_region.h:195-196), so the
    # reported plane is the fit of the final members even below the
    # re-estimation period; degenerate fits recenter on the member centroid
    # with the sticky normal (plane_estimator.cc:224-227).
    m, sol = refit_moments(slots)
    final_plane = jnp.where(
        sol.valid[:, None], sol.plane,
        geom.plane_from_normal_point(slots.hint, sol.centroid))
    gather = jnp.argsort(jnp.where(slot_id >= 0, slot_id, k_cap))
    def take(a):
        return a[gather]
    return PlanarRegions(
        labels=new_labels,
        num_regions=num_regions,
        planes=take(final_plane),
        centroids=take(sol.centroid),
        curvatures=take(sol.curvature),
        counts=take(counts),
        seed_indices=take(slots.seed_idx),
        moments=plane_fit.PlaneMoments(
            s2=take(m.s2), s1=take(m.s1), w=take(m.w),
            normal_hint=take(m.normal_hint)),
        # diagnostic: qualified seeds left outside every grown region
        overflow=bk.psum(jnp.sum(
            ((rank_grid < inf_rank) & ~jnp.any(members, axis=0))
            .astype(jnp.int32))) > 0,
    )
