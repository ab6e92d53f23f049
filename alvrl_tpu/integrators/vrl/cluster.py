"""Adaptive LightSlice clustering of the VRL set.

Counterpart of src/integrators/vrl/Preprocessor.cpp, re-structured:

  * slicing (6D median split of gather points), representative-pixel
    sampling, locality kNN, and the adaptive cluster refinement are
    host-side numpy — inherently sequential, tiny data, runs once per
    pass off the device critical path (SURVEY §7 step 9);
  * the transfer matrix R is built on device (see integrator.build_R)
    with the same blocked kernel as rendering;
  * the result is packed into fixed-shape device tables
    (pixel->slice image + padded per-slice representative/weight arrays)
    for the clustered render kernel.

Algorithmic fidelity notes (quirks preserved on purpose):
  * cluster variance splits into *undersampling* variance
    W * sum(x^2/w) - (sum x)^2 and *integration* variance W * sum(var/w),
    locality-weighted per gather row (calculateClusterVariance,
    Preprocessor.cpp:1059-1120 — our closed form equals their
    incremental recurrence);
  * column weights are locality-weighted RMS of (mean^2 + var) with a 1%
    average-weight safety floor (calculateColumnWeigths, :985-1008);
  * adaptive refinement keeps splitting the max-variance cluster while
    the convergence constant (numVrls * pixelUndersampling + numClusters)
    * clusteredVariance decreases, with the provable lower-bound early
    exit and snapshot rollback (refineAdaptively, :402-489);
  * zero-contribution VRLs are quarantined into one extra cluster
    (cluster(), :882-897); representatives are sampled proportional to
    column weight with weight = 1/probability (sampleRepresentatives,
    :354-378); singleton clusters get weight 1.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

UINT32_MAX = np.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# Slicing (Preprocessor.cpp:1130-1499)
# ---------------------------------------------------------------------------

@dataclass
class Slices:
    pixel_to_slice: np.ndarray       # (H*W,) uint32, UINT32_MAX = no gather pt
    members: list                    # per slice: np.ndarray of pixel indices
    pos_centroid: np.ndarray         # (S, 3)
    dir_centroid: np.ndarray         # (S, 3)


def build_slices(positions, directions, valid, target_num_slices):
    """6D top-down median split.

    positions: (P, 3) gather points; directions: (P, 3) scaled normals;
    valid: (P,) bool. Invalid pixels map to UINT32_MAX (fall-back
    cluster), the semantics of getSlices (Preprocessor.cpp:1200-1227).
    """
    n = len(positions)
    pixel_to_slice = np.full((n,), UINT32_MAX, dtype=np.uint32)
    good = np.nonzero(valid)[0]
    if len(good) == 0:
        return Slices(pixel_to_slice, [], np.zeros((0, 3)), np.zeros((0, 3)))

    six = np.concatenate([positions, directions], axis=1).astype(np.float64)
    six = np.where(valid[:, None], six, 0.0)  # nodes only index valid ids

    counter = 0

    def make_node(idx):
        nonlocal counter
        counter += 1
        if len(idx) == 1:
            return (-0.0, counter, idx, None, None, None, None)
        lo = six[idx].min(axis=0)
        hi = six[idx].max(axis=0)
        diff = hi - lo
        # distance = 6D bbox diagonal (sliceDistance of min/max corners)
        dist = float(np.sqrt(np.sum(diff * diff)))
        # split on max-extent dim, position dims vs direction dims chosen
        # by larger extent within each triplet (findSplit, :1432-1487)
        dim_pos = int(np.argmax(diff[:3]))
        dim_dir = int(np.argmax(diff[3:]))
        if diff[:3][dim_pos] > diff[3:][dim_dir]:
            dim = dim_pos
        else:
            dim = 3 + dim_dir
        split = lo[dim] + 0.5 * diff[dim]
        centroid = lo + 0.5 * diff
        return (-dist, counter, idx, dim, split, centroid[:3], centroid[3:])

    heap = [make_node(good)]
    while len(heap) < target_num_slices and -heap[0][0] > 0:
        _, _, idx, dim, split, _, _ = heapq.heappop(heap)
        larger = six[idx][:, dim] > split
        heapq.heappush(heap, make_node(idx[~larger]))
        heapq.heappush(heap, make_node(idx[larger]))

    members = []
    pos_c = []
    dir_c = []
    for s, (_, _, idx, _, _, pc, dc) in enumerate(heap):
        members.append(idx)
        pixel_to_slice[idx] = s
        if pc is None:  # singleton: centroid is the point itself
            pc, dc = six[idx[0]][:3], six[idx[0]][3:]
        pos_c.append(pc)
        dir_c.append(dc)
    return Slices(
        pixel_to_slice, members,
        np.asarray(pos_c), np.asarray(dir_c),
    )


def sample_representative_pixels(slices: Slices, target_undersampling, rng):
    """Per slice: pick ~numPixels/undersampling representative pixels,
    at least 2 (Slice::sampleRepresentativePixels, :66-121).
    Returns (list of index arrays, slice_undersampling (S,), global_pu)."""
    repr_idx = []
    slice_u = []
    total = 0
    total_repr = 0
    for idx in slices.members:
        n = len(idx)
        target = int(0.5 + n / target_undersampling)
        target = max(target, min(2, n))
        target = min(target, n)
        sel = rng.choice(idx, size=target, replace=False) if target < n else idx.copy()
        repr_idx.append(np.asarray(sel))
        slice_u.append(target / n)
        total += n
        total_repr += target
    return repr_idx, np.asarray(slice_u), (total_repr / max(total, 1))


def build_localities(slices: Slices, neighbour_count):
    """kNN among slice centroids in 6D (buildLocalities, :1241-1293).
    Returns per slice a list of (neighbour_idx, distance)."""
    s = len(slices.members)
    if neighbour_count <= 0 or s <= 1:
        return [[] for _ in range(s)]
    c = np.concatenate([slices.pos_centroid, slices.dir_centroid], axis=1)
    d2 = np.sum((c[:, None, :] - c[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    k = min(neighbour_count, s - 1)
    out = []
    for i in range(s):
        nn = np.argpartition(d2[i], k - 1)[:k]
        out.append([(int(j), float(np.sqrt(d2[i, j]))) for j in nn])
    return out


# ---------------------------------------------------------------------------
# Clustering with the variance cost model (Preprocessor.cpp:287-720)
# ---------------------------------------------------------------------------

def column_weights(mean, var, loc_w, safety_fraction=1e-2):
    """Locality-weighted RMS of (mean^2 + var) per column + safety floor
    (calculateColumnWeigths)."""
    x = mean.astype(np.float64) ** 2 + var.astype(np.float64)
    w = np.sqrt(np.maximum(loc_w @ x, 0.0))
    avg = w.mean() if len(w) else 0.0
    if avg == 0:
        avg = 1.0
    return w + avg * safety_fraction


def unclustered_variance(mean, var, loc_w, cols):
    """(tracerVariance, integrationVariance) over the given columns
    (calculateUnclusteredVariance)."""
    x = mean[:, cols].astype(np.float64)
    v = var[:, cols].astype(np.float64)
    n = x.shape[1]
    if n <= 1:
        return 0.0, float(loc_w @ v.sum(axis=1)) if n else 0.0
    xbar = x.mean(axis=1, keepdims=True)
    m2 = ((x - xbar) ** 2).sum(axis=1)
    integ = float(loc_w @ v.sum(axis=1))
    tracer = float(loc_w @ m2) - integ
    return tracer, integ


class _Cluster:
    __slots__ = ("begin", "end", "uvar", "ivar")

    def __init__(self, begin, end, uvar, ivar):
        self.begin, self.end, self.uvar, self.ivar = begin, end, uvar, ivar


class Clustering:
    """Contiguous-range clustering over an ordering of VRL columns.

    mean/var: (P, N) full matrices (only the listed columns are used);
    loc_w: (P,) locality weights summing to 1; pixel_undersampling in
    (0, 1]; clusters are ranges of `self.order`.
    """

    def __init__(self, vrls_per_cluster, mean, var, loc_w, pixel_undersampling,
                 depth_correction=1.0, rng=None):
        self.mean = mean.astype(np.float64)
        self.var = var.astype(np.float64)
        self.loc_w = np.asarray(loc_w, np.float64)
        self.pu = float(pixel_undersampling)
        self.depth_correction = float(depth_correction)
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.col_w = column_weights(self.mean, self.var, self.loc_w)

        self.order = np.concatenate([np.asarray(c, np.int64) for c in vrls_per_cluster])
        self.n_vrls_total = mean.shape[1]
        self.singletons: list[int] = []
        self.pq: list[tuple] = []  # max-heap via negated key
        self._push_counter = 0
        self.c_uvar = 0.0
        self.c_ivar = 0.0
        begin = 0
        for c in vrls_per_cluster:
            end = begin + len(c)
            self._add_cluster(begin, end)
            begin = end

        self.tracer_var, self.unclustered_ivar = unclustered_variance(
            self.mean, self.var, self.loc_w, self.order
        )

    # --- variance bookkeeping -----------------------------------------

    def _range_variance(self, begin, end):
        cols = self.order[begin:end]
        x = self.mean[:, cols]
        v = self.var[:, cols]
        w = self.col_w[cols]
        W = w.sum()
        uvar = float(self.loc_w @ (W * (x * x / w).sum(axis=1) - x.sum(axis=1) ** 2))
        ivar = float(self.loc_w @ (W * (v / w).sum(axis=1)))
        return max(uvar, 0.0), max(ivar, 0.0)

    def _prefix_variances(self, cols):
        """Incremental (uvar, ivar) for prefixes of the ordered columns."""
        x = self.mean[:, cols]
        v = self.var[:, cols]
        w = self.col_w[cols]
        A = np.cumsum(x, axis=1)
        B = np.cumsum(x * x / w, axis=1)
        C = np.cumsum(v / w, axis=1)
        W = np.cumsum(w)
        uvar = self.loc_w @ (W[None, :] * B - A * A)
        ivar = self.loc_w @ (W[None, :] * C)
        return np.maximum(uvar, 0.0), np.maximum(ivar, 0.0)

    def _add_cluster(self, begin, end, uvar=None, ivar=None):
        if end <= begin:
            raise ValueError("empty cluster")
        if end == begin + 1:
            self.singletons.append(int(self.order[begin]))
            if uvar is None:
                _, ivar = self._range_variance(begin, end)
            self.c_ivar += ivar
            return
        if uvar is None:
            uvar, ivar = self._range_variance(begin, end)
        self._push_counter += 1
        heapq.heappush(
            self.pq, (-(uvar + ivar), self._push_counter, _Cluster(begin, end, uvar, ivar))
        )
        self.c_uvar += uvar
        self.c_ivar += ivar

    def _pop_cluster(self) -> _Cluster:
        _, _, c = heapq.heappop(self.pq)
        self.c_uvar -= c.uvar
        self.c_ivar -= c.ivar
        return c

    # --- public costs ---------------------------------------------------

    def num_clusters(self):
        return len(self.singletons) + len(self.pq)

    def unclustered_var(self):
        return self.tracer_var + self.unclustered_ivar

    def clustered_var(self):
        return self.tracer_var + self.c_uvar + self.c_ivar

    def convergence_constant(self):
        return (len(self.order) * self.pu + self.num_clusters()) * self.clustered_var()

    def lower_bound_future(self):
        return (len(self.order) * self.pu + self.num_clusters()) * self.unclustered_var()

    def unclustered_convergence_constant(self):
        return len(self.order) * self.unclustered_var()

    # --- splitting ------------------------------------------------------

    def _weighted_sample(self, begin, end, exclude=None):
        cols = self.order[begin:end]
        w = self.col_w[cols].copy()
        if exclude is not None:
            w[cols == exclude] = 0.0
        total = w.sum()
        if total <= 0:
            j = int(self.rng.integers(0, end - begin))
            return begin + j, 1.0 / (end - begin)
        p = w / total
        j = int(self.rng.choice(end - begin, p=p))
        return begin + j, float(p[j])

    def _split(self, c: _Cluster):
        begin, end = c.begin, c.end
        if end - begin < 2:
            return False
        i1, _ = self._weighted_sample(begin, end)
        v1 = int(self.order[i1])
        i2, _ = self._weighted_sample(begin, end, exclude=v1)
        v2 = int(self.order[i2])

        col1 = self.mean[:, v1]
        col2 = self.mean[:, v2]
        diff = col2 - col1
        dlen = np.linalg.norm(diff)
        if np.linalg.norm(col1) != 0 and np.linalg.norm(col2) != 0 and dlen != 0:
            direction = diff / dlen
        else:
            direction = self.rng.standard_normal(self.mean.shape[0])
            direction /= max(np.linalg.norm(direction), 1e-30)

        cols = self.order[begin:end]
        colmat = self.mean[:, cols]
        norms = np.linalg.norm(colmat, axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            proj = np.where(norms > 0, (direction @ colmat) / norms, 0.0)
        sort_idx = np.argsort(proj, kind="stable")
        self.order[begin:end] = cols[sort_idx]

        cols_sorted = self.order[begin:end]
        u_fwd, i_fwd = self._prefix_variances(cols_sorted)
        u_bwd, i_bwd = self._prefix_variances(cols_sorted[::-1])
        k = end - begin
        # split at index s (start of second cluster), s in [1, k-1]
        s = np.arange(1, k)
        total = u_fwd[s - 1] + i_fwd[s - 1] + u_bwd[k - 1 - s] + i_bwd[k - 1 - s]
        best = int(s[np.argmin(total)])
        self._add_cluster(begin, begin + best, u_fwd[best - 1], i_fwd[best - 1])
        self._add_cluster(begin + best, end, u_bwd[k - 1 - best], i_bwd[k - 1 - best])
        return True

    # --- refinement -----------------------------------------------------

    def refine(self, undersampling):
        if undersampling > 0:
            return self._refine_fixed(undersampling)
        return self._refine_adaptive()

    def _refine_fixed(self, undersampling):
        target = int(0.5 + len(self.order) / undersampling)
        while self.num_clusters() < target and len(self.pq) > 0:
            c = self._pop_cluster()
            self._split(c)
        return True

    def _snapshot(self):
        return (
            self.c_uvar, self.c_ivar, list(self.pq), list(self.singletons),
        )

    def _restore(self, snap):
        self.c_uvar, self.c_ivar, pq, singles = snap
        self.pq = list(pq)
        heapq.heapify(self.pq)
        self.singletons = list(singles)

    def _refine_adaptive(self):
        if len(self.pq) == 0:
            return True
        if self.unclustered_var() == 0:
            return False

        rng_state0 = self.rng.bit_generator.state
        best = self.convergence_constant()
        snap = self._snapshot()
        n_splits = 0
        best_splits = 0
        while len(self.pq) > 0:
            c = self._pop_cluster()
            self._split(c)
            n_splits += 1
            cur = self.convergence_constant()
            if cur < best:
                best = cur
                best_splits = n_splits
                if self.depth_correction == 1.0:
                    snap = self._snapshot()
            if self.lower_bound_future() >= best:
                break
        self._restore(snap)

        if self.depth_correction != 1.0:
            # replay the same RNG stream, split to the corrected depth
            # (refineAdaptively depthCorrection branch, :456-469)
            self.rng.bit_generator.state = rng_state0
            corrected = int(0.5 + self.depth_correction * best_splits)
            for _ in range(corrected):
                if len(self.pq) == 0:
                    break
                c = self._pop_cluster()
                self._split(c)
        return True

    # --- outputs --------------------------------------------------------

    def sample_representatives(self):
        """(vrl_ids, weights): singletons weight 1; multi-clusters sample
        one column ~ columnWeight, weight = 1/probability."""
        ids = []
        ws = []
        for v in self.singletons:
            ids.append(v)
            ws.append(1.0)
        for _, _, c in self.pq:
            j, prob = self._weighted_sample(c.begin, c.end)
            ids.append(int(self.order[j]))
            ws.append(1.0 / max(prob, 1e-30))
        return np.asarray(ids, np.int64), np.asarray(ws, np.float64)

    def vrls_per_cluster(self):
        out = [np.asarray([v]) for v in self.singletons]
        for _, _, c in self.pq:
            out.append(self.order[c.begin:c.end].copy())
        return out


# ---------------------------------------------------------------------------
# The full pipeline (buildClusters, Preprocessor.cpp:133-283)
# ---------------------------------------------------------------------------

@dataclass
class ClusterParams:
    target_num_slices: int = 100
    target_pixel_undersampling: float = 64.0
    slice_curvature_factor: float = 0.5
    neighbour_count: int = 0
    neighbour_weight: float = 0.0
    global_cluster: bool = False
    global_undersampling: float = -1.0
    local_refinement: bool = True
    local_undersampling: float = -1.0
    fallback_undersampling: float = 5.0
    depth_correction: float = 1.0


@dataclass
class ClusterInfo:
    """Device-ready clustering result (counterpart of vrlClusterInfo,
    vrlIntegrator.cpp:17-115), padded to fixed shapes."""

    pixel_to_slice: np.ndarray    # (H*W,) int32; -1 => fall-back
    slice_vrls: np.ndarray        # (S, Cmax) int32 vrl ids (pad 0)
    slice_weights: np.ndarray     # (S, Cmax) f32 (pad 0)
    fallback_vrls: np.ndarray     # (Cf,) int32
    fallback_weights: np.ndarray  # (Cf,) f32
    gc_vrls: np.ndarray           # global-cluster representatives
    gc_weights: np.ndarray


def build_clusters(
    R_mean,           # (P, N) luminance means of all representative rows
    R_var,            # (P, N)
    rows_per_slice,   # list of row-index arrays into R_mean, per slice
    slice_undersampling,  # (S,)
    global_pixel_undersampling,
    localities,       # per slice list of (neighbour, distance)
    params: ClusterParams,
    rng,
    backend: str = "auto",
):
    """Full pipeline: global cluster -> fall-back -> per-slice refinement.
    Returns (per-slice ids list, per-slice weights list, fallback ids,
    fallback weights, gc ids, gc weights).

    backend: "auto" (or "native") runs the native C++ module (threaded
    over slices, native/cluster_refine.cpp — the ClusterRefiner-threads
    counterpart, Preprocessor.cpp:722-773), built at first use; "numpy"
    runs this implementation, the executable spec."""
    if backend != "numpy":
        from alvrl_tpu.integrators.vrl import cluster_native

        return cluster_native.build_clusters(
            R_mean, R_var, rows_per_slice, slice_undersampling,
            global_pixel_undersampling, localities, params, rng,
        )
    p_total, n_vrls = R_mean.shape

    # 1) zero-contribution quarantine (cluster(), :843-897)
    col_total = R_mean.sum(axis=0)
    nonzero = np.nonzero(col_total != 0)[0]
    zero = np.nonzero(col_total == 0)[0]

    uniform_loc = np.full((p_total,), 1.0 / max(p_total, 1))

    if len(nonzero) > 0 and params.global_cluster:
        gcl = Clustering([nonzero], R_mean, R_var, uniform_loc,
                         global_pixel_undersampling, rng=rng)
        gcl.refine(params.global_undersampling)
        vrls_per_cluster = gcl.vrls_per_cluster()
    elif len(nonzero) > 0:
        vrls_per_cluster = [nonzero]
    else:
        vrls_per_cluster = []
    if len(zero) > 0:
        vrls_per_cluster = vrls_per_cluster + [zero]

    # 2) global representatives + fall-back refinement
    global_clustering = Clustering(
        vrls_per_cluster, R_mean, R_var, uniform_loc,
        global_pixel_undersampling, rng=rng,
    )
    gc_ids, gc_w = global_clustering.sample_representatives()
    if not global_clustering.refine(params.fallback_undersampling):
        fb_ids, fb_w = gc_ids, gc_w
    else:
        fb_ids, fb_w = global_clustering.sample_representatives()

    # 3) per-slice local refinement
    slice_ids = []
    slice_ws = []
    n_slices = len(rows_per_slice)
    for i in range(n_slices):
        rows = [np.asarray(rows_per_slice[i])]
        weights = None
        if params.neighbour_weight > 0 and localities[i]:
            nb_w = []
            for (j, dist) in localities[i]:
                rows.append(np.asarray(rows_per_slice[j]))
                nb_w.append(1.0 / max(dist, 1e-30))
            summed_nb = sum(nb_w)
            slice_w = summed_nb * (1 - params.neighbour_weight) / params.neighbour_weight
            norm = 1.0 / (slice_w + summed_nb)
            weights = [np.full(len(rows[0]), slice_w * norm / len(rows[0]))]
            for k, (j, dist) in enumerate(localities[i]):
                weights.append(np.full(len(rows[k + 1]), nb_w[k] * norm / len(rows[k + 1])))
            loc_w = np.concatenate(weights)
        else:
            loc_w = np.full(len(rows[0]), 1.0 / max(len(rows[0]), 1))
        row_idx = np.concatenate(rows)
        sub_mean = R_mean[row_idx]
        sub_var = R_var[row_idx]

        cl = Clustering(
            vrls_per_cluster, sub_mean, sub_var, loc_w,
            slice_undersampling[i], params.depth_correction, rng=rng,
        )
        if not params.local_refinement:
            ids, ws = cl.sample_representatives()
        elif cl.refine(params.local_undersampling):
            ids, ws = cl.sample_representatives()
        else:
            ids, ws = fb_ids, fb_w
        slice_ids.append(ids)
        slice_ws.append(ws)

    return slice_ids, slice_ws, fb_ids, fb_w, gc_ids, gc_w


def pack_cluster_info(
    pixel_to_slice, slice_ids, slice_ws, fb_ids, fb_w, gc_ids, gc_w
) -> ClusterInfo:
    """Pad per-slice representative lists to a fixed (S, Cmax) table."""
    s = len(slice_ids)
    cmax = max([len(a) for a in slice_ids] + [1])
    vrls = np.zeros((s, cmax), np.int32)
    ws = np.zeros((s, cmax), np.float32)
    for i in range(s):
        k = len(slice_ids[i])
        vrls[i, :k] = slice_ids[i]
        ws[i, :k] = slice_ws[i]
    p2s = pixel_to_slice.astype(np.int64)
    p2s = np.where(p2s == int(UINT32_MAX), -1, p2s).astype(np.int32)
    return ClusterInfo(
        pixel_to_slice=p2s,
        slice_vrls=vrls,
        slice_weights=ws,
        fallback_vrls=np.asarray(fb_ids, np.int32),
        fallback_weights=np.asarray(fb_w, np.float32),
        gc_vrls=np.asarray(gc_ids, np.int32),
        gc_weights=np.asarray(gc_w, np.float32),
    )
