"""Keyframe map management — the MapHandler equivalent.

Behavioral spec: reference ``src/mapHandler.cpp`` — addKeyFrame (:121),
matchKF2KFPoints (:237, per-observer full_graph increments :322-351),
matchKF2KFLines (:368, Pluecker branch :433-590 incl. the world-frame
renormalization :451-459 and the chi^2 creation gate :489-494),
matchMap2KFPoints/Lines (:697-921, grid-window + mutual NNR + maxKFEpip
gates), lookForCommonMatches (:923), expandGraphs (:992), formLocalMap
(:1005), local BA write-back + observation pruning with full_graph
decrements (:6154-6319, :2251-2252), removeBadMapLandmarks (:3732),
removeRedundantKFs (:3899-4047 incl. the full_graph row clearing).

Architecture: the *dynamic topology* (landmark creation/culling, growing
observation tables, covisibility counts) lives in host numpy as flat,
preallocated, capacity-doubling tables — no per-landmark Python objects and
no per-landmark array growth.  Every *numeric* step (descriptor matching,
projection gates, bundle adjustment) is a fixed-shape jitted device
program; the host paths are batched numpy over the flat tables.  This
replaces the reference's pointer-soup map + mutex protocol:
the device never sees a pointer, only padded index tables.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import lie
from ..core.camera import StereoCamera
from ..core.numerics import full_f32_matmuls
from ..core.plucker import (
    plucker_to_orth,
    orth_to_plucker,
    transform_plucker,
)
from ..frontend.features import LineSet, PointSet, StereoFeatures
from ..ops import matching as M
from . import ba as ba_mod

log = logging.getLogger("plslam")


class LocalBAResult(NamedTuple):
    """Host-side summary of one local-BA solve (packed transport)."""

    T_c_w: np.ndarray
    points: np.ndarray
    p_active: np.ndarray
    l_active: np.ndarray
    cost: float

CHI2_GATE = 5.991  # mapHandler.cpp:489, :6131


@dataclass
class MapConfig:
    min_lm_obs: int = 5           # slamConfig min_lm_obs
    cull_age: int = 10            # remove... :3741 "older than 10 KFs"
    min_lm_cov_graph: int = 75    # formLocalMap :1052
    min_kf_local_map: int = 3     # formLocalMap :1118
    max_kf_epip_p: float = 1.0    # matchMap2KF accept gate :778
    max_kf_epip_l: float = 1.0    # matchMap2KFLines accept gate :894
    match_window: float = 40.0    # projected-grid window (f2f cells)
    nnr: float = 0.9
    line_sim_th: float = 0.75     # direction cosine filter (matching.cpp:221)
    use_lines: bool = True
    plucker_lines: bool = True
    min_pt_matches: int = 10      # windowed->global fallback gate :277-281
    min_ls_matches: int = 6       # SlamConfig::minLineMatches (:875-878)
    has_refinement: bool = False  # SlamConfig::hasRefinement :937-977
    kf_inlier_ratio: float = 30.0  # refined-pose acceptance gate :952-958
    min_features: int = 10        # refined-pose min inliers :967
    # re-elect landmark descriptors every N KFs (0 = never).  The
    # reference re-elects per landmark on every observation change
    # (updateAverageDescDir, mapFeatures.cpp:52-140); the batched
    # equivalent re-elects ALL landmarks periodically.
    desc_refresh_kfs: int = 8
    cull_kf_every: int = 0        # run removeRedundantKFs every N KFs
    max_common_fts_kf: float = 0.9  # :3899 shared-landmark ratio
    local_ba_kf: int = 16         # padded local-KF capacity for the BA
    ba_points: int = 1024         # padded BA landmark capacities (per chunk)
    ba_lines: int = 256
    ba_pobs: int = 4096
    ba_lobs: int = 1024
    # solver-divergence guard (SURVEY.md §5 failure-detection analog of
    # isGoodSolution): a bounded robust cost can ACCEPT an LM step that
    # flings a weakly-constrained pose tens of meters (observed once in
    # 213 KFs on the 500-frame nuisance e2e: KFs 184-189 jumped 17-28 m
    # and the run's ATE went 1.1 -> 13.7 m).  A local BA whose largest
    # pose translation change exceeds lba_max_jump (m) is discarded with
    # a warning; GBA gets the looser gba_max_jump.  0 disables.
    lba_max_jump: float = 1.0
    gba_max_jump: float = 10.0


@jax.jit
def _pack_feats(feats: StereoFeatures):
    """Flatten a feature pytree into ONE dense f32 buffer so the host copy
    costs one transfer, not ~24 (each transfer pays a device round trip).
    Descriptors ride along bitcast to f32."""
    p, l = feats.points, feats.lines
    fp = jnp.concatenate([p.uv, p.P, p.sigma2[:, None],
                          p.valid.astype(jnp.float32)[:, None]], axis=1)
    fl = jnp.concatenate([l.sp, l.ep, l.sP, l.eP, l.NDc, l.sigma2[:, None],
                          l.valid.astype(jnp.float32)[:, None]], axis=1)
    desc = jax.lax.bitcast_convert_type(
        jnp.concatenate([p.desc, l.desc], axis=0), jnp.float32)
    return jnp.concatenate([fp.ravel(), fl.ravel(), desc.ravel()])


class KeyframeRecord:
    """Host-side record of one keyframe (deep copy of the frame's features,
    keyFrame.cpp:31-79).  The original device pytree is kept in ``dev`` so
    association programs read features that are ALREADY device-resident —
    re-uploading them costs ~130 ms/KF in transfer latency."""

    def __init__(self, kf_id: int, pose: np.ndarray, feats: StereoFeatures,
                 packed: np.ndarray | None = None):
        self.id = kf_id
        self.active = True
        self.T_w_k = pose.astype(np.float64)        # camera -> world
        self.dev = feats
        n_pt = feats.points.uv.shape[0]
        n_ls = feats.lines.sp.shape[0]
        if packed is not None:
            # the fused association program already returned the packed
            # host copy in its single fetch — no extra round trip
            buf = packed
        else:
            buf = np.asarray(jax.device_get(_pack_feats(feats)))
        fp = buf[: n_pt * 7].reshape(n_pt, 7)
        fl = buf[n_pt * 7: n_pt * 7 + n_ls * 18].reshape(n_ls, 18)
        desc = buf[n_pt * 7 + n_ls * 18:].reshape(n_pt + n_ls, 8).view(
            np.uint32)
        self.pt_uv = fp[:, 0:2]
        self.pt_P = fp[:, 2:5]
        self.pt_sigma2 = fp[:, 5]
        self.pt_valid = fp[:, 6] > 0.5
        self.pt_desc = np.asarray(desc[:n_pt])
        self.pt_lm = np.full(n_pt, -1, np.int64)
        self.ls_sp = fl[:, 0:2]
        self.ls_ep = fl[:, 2:4]
        self.ls_sP = fl[:, 4:7]
        self.ls_eP = fl[:, 7:10]
        self.ls_NDc = fl[:, 10:16]
        self.ls_sigma2 = fl[:, 16]
        self.ls_valid = fl[:, 17] > 0.5
        self.ls_desc = np.asarray(desc[n_pt:])
        self.ls_lm = np.full(len(fl), -1, np.int64)

    def dev_feats(self) -> StereoFeatures:
        """Device-resident features; rebuilt (once) from the host copy for
        checkpoint-restored records."""
        if getattr(self, "dev", None) is None:
            n, m = len(self.pt_uv), len(self.ls_sp)
            pts = PointSet.empty(n)._replace(
                uv=jnp.asarray(self.pt_uv, jnp.float32),
                P=jnp.asarray(self.pt_P, jnp.float32),
                desc=jnp.asarray(self.pt_desc),
                sigma2=jnp.asarray(self.pt_sigma2, jnp.float32),
                valid=jnp.asarray(self.pt_valid))
            ls = LineSet.empty(m)._replace(
                sp=jnp.asarray(self.ls_sp, jnp.float32),
                ep=jnp.asarray(self.ls_ep, jnp.float32),
                sP=jnp.asarray(self.ls_sP, jnp.float32),
                eP=jnp.asarray(self.ls_eP, jnp.float32),
                NDc=jnp.asarray(self.ls_NDc, jnp.float32),
                desc=jnp.asarray(self.ls_desc),
                sigma2=jnp.asarray(self.ls_sigma2, jnp.float32),
                valid=jnp.asarray(self.ls_valid))
            self.dev = StereoFeatures(points=pts, lines=ls)
        return self.dev


def _grow(buf: np.ndarray, need: int) -> np.ndarray:
    """Double a capacity buffer until it holds ``need`` rows."""
    cap = len(buf)
    if need <= cap:
        return buf
    cap = max(cap, 1)
    while cap < need:
        cap *= 2
    out = np.zeros((cap,) + buf.shape[1:], buf.dtype)
    out[: len(buf)] = buf
    return out


class _ObsTable:
    """Flat observation store: (lm, kf, feat) rows with tombstoned removal
    — the array-ization of the reference's per-landmark obs/kf_obs lists
    (mapFeatures.h:60-66, :105-112).

    Per-landmark row lookup goes through a LAZY sorted index (live rows
    argsorted by landmark, rebuilt on first query after any mutation), so
    every maintenance path is bulk numpy instead of per-row Python list
    surgery — the flat-per-KF host cost fix of VERDICT r3 weak #4."""

    def __init__(self, cap: int = 1024):
        self.lm = np.zeros(cap, np.int64)
        self.kf = np.zeros(cap, np.int64)
        self.fi = np.zeros(cap, np.int64)
        self.valid = np.zeros(cap, bool)
        self.n = 0
        self._order = None   # live rows sorted (stable) by landmark
        self._olm = None     # lm of those rows (sorted)

    def invalidate(self):
        self._order = None

    def _idx_insert(self, rows: np.ndarray):
        """Merge new live rows into the sorted index (one O(total) memcpy
        via np.insert instead of a full argsort rebuild — the argsort was
        the dominant per-KF host cost at 1000-KF scale)."""
        if self._order is None or not len(rows):
            return
        tlm = self.lm[rows]
        t_order = np.argsort(tlm, kind="stable")
        rows, tlm = rows[t_order], tlm[t_order]
        # 'right': new rows append AFTER existing equals (insertion order)
        pos = np.searchsorted(self._olm, tlm, "right")
        self._order = np.insert(self._order, pos, rows)
        self._olm = np.insert(self._olm, pos, tlm)

    def _idx_remove(self, rows: np.ndarray):
        if self._order is None or not len(rows):
            return
        rm = np.zeros(self.n, bool)
        rm[rows] = True
        keep = ~rm[self._order]
        self._order = self._order[keep]
        self._olm = self._olm[keep]

    def _index(self):
        if self._order is None:
            live = np.where(self.valid[: self.n])[0]
            self._order = live[np.argsort(self.lm[live], kind="stable")]
            self._olm = self.lm[self._order]
        return self._order, self._olm

    def group_slices(self, lms):
        """(order, lo, hi): each landmark's live rows are
        order[lo[i]:hi[i]], in insertion order."""
        order, olm = self._index()
        lms = np.asarray(lms, np.int64)
        return order, np.searchsorted(olm, lms, "left"), \
            np.searchsorted(olm, lms, "right")

    def rows_of(self, lms) -> np.ndarray:
        """Concatenated live rows of the given landmarks (insertion order
        within each landmark)."""
        order, lo, hi = self.group_slices(lms)
        lens = hi - lo
        total = int(lens.sum())
        if not total:
            return np.zeros(0, np.int64)
        idx = (np.arange(total)
               - np.repeat(np.cumsum(lens) - lens, lens)
               + np.repeat(lo, lens))
        return order[idx]

    def append(self, lms: np.ndarray, kf_id: int, fis: np.ndarray) -> np.ndarray:
        k = len(lms)
        need = self.n + k
        if need > len(self.lm):
            self.lm = _grow(self.lm, need)
            self.kf = _grow(self.kf, need)
            self.fi = _grow(self.fi, need)
            self.valid = _grow(self.valid, need)
        rows = np.arange(self.n, self.n + k)
        self.lm[rows] = lms
        self.kf[rows] = kf_id
        self.fi[rows] = fis
        self.valid[rows] = True
        self.n = need
        self._idx_insert(rows)
        return rows


class SlamMap:
    """Fixed-layout landmark store + flat observation tables + covisibility.

    All landmark state lives in capacity-doubling numpy buffers exposed as
    slice views (``pt_w`` etc.), so consumers index and assign as if they
    were plain arrays while creation is O(1) amortized.
    """

    _PT_CAP0 = 4096
    _LS_CAP0 = 1024

    def __init__(self, cfg: MapConfig):
        self.cfg = cfg
        self.keyframes: list[KeyframeRecord] = []
        # covis lives in a capacity-doubling square buffer exposed as a
        # (K, K) view — per-KF expandGraphs is O(1) amortized instead of
        # an O(K^2) reallocation every keyframe
        self._covis_buf = np.zeros((16, 16), np.int32)
        # point landmarks
        self.n_pt = 0
        self._pt_w = np.zeros((self._PT_CAP0, 3))
        self._pt_desc = np.zeros((self._PT_CAP0, 8), np.uint32)
        self._pt_valid = np.zeros(self._PT_CAP0, bool)
        self._pt_first_kf = np.zeros(self._PT_CAP0, np.int64)
        self._pt_last_kf = np.zeros(self._PT_CAP0, np.int64)
        self._pt_nobs = np.zeros(self._PT_CAP0, np.int64)
        self.pobs = _ObsTable()
        # line landmarks (world Pluecker, normalized ||d||=1) + world
        # endpoints (the endpoint-mode state, line3D of the reference's
        # non-Pluecker branch :591-692; kept in both modes)
        self.n_ls = 0
        self._ls_w = np.zeros((self._LS_CAP0, 6))
        self._ls_epw = np.zeros((self._LS_CAP0, 2, 3))
        self._ls_desc = np.zeros((self._LS_CAP0, 8), np.uint32)
        self._ls_valid = np.zeros(self._LS_CAP0, bool)
        self._ls_first_kf = np.zeros(self._LS_CAP0, np.int64)
        self._ls_last_kf = np.zeros(self._LS_CAP0, np.int64)
        self._ls_nobs = np.zeros(self._LS_CAP0, np.int64)
        self.lobs = _ObsTable(256)

    # -- array views (live prefix of the capacity buffers) -----------------

    def _view(name):  # noqa: N805 — descriptor factory
        buf, cnt = "_" + name.split("__")[0], name.split("__")[1]

        def get(self):
            return getattr(self, buf)[: getattr(self, cnt)]

        def set_(self, value):
            getattr(self, buf)[: getattr(self, cnt)] = value

        return property(get, set_)

    pt_w = _view("pt_w__n_pt")
    pt_desc = _view("pt_desc__n_pt")
    pt_valid = _view("pt_valid__n_pt")
    pt_first_kf = _view("pt_first_kf__n_pt")
    pt_last_kf = _view("pt_last_kf__n_pt")
    pt_nobs = _view("pt_nobs__n_pt")
    ls_w = _view("ls_w__n_ls")
    ls_epw = _view("ls_epw__n_ls")
    ls_desc = _view("ls_desc__n_ls")
    ls_valid = _view("ls_valid__n_ls")
    ls_first_kf = _view("ls_first_kf__n_ls")
    ls_last_kf = _view("ls_last_kf__n_ls")
    ls_nobs = _view("ls_nobs__n_ls")
    del _view

    # -- landmark creation (batched) ---------------------------------------

    def new_points(self, Pw: np.ndarray, desc: np.ndarray, kf_id: int,
                   fis: np.ndarray) -> np.ndarray:
        """Create N point landmarks seeded by one observation each.
        Returns the new landmark ids."""
        k = len(Pw)
        if k == 0:
            return np.zeros(0, np.int64)
        need = self.n_pt + k
        self._pt_w = _grow(self._pt_w, need)
        self._pt_desc = _grow(self._pt_desc, need)
        self._pt_valid = _grow(self._pt_valid, need)
        self._pt_first_kf = _grow(self._pt_first_kf, need)
        self._pt_last_kf = _grow(self._pt_last_kf, need)
        self._pt_nobs = _grow(self._pt_nobs, need)
        ids = np.arange(self.n_pt, need)
        self._pt_w[ids] = Pw
        self._pt_desc[ids] = desc
        self._pt_valid[ids] = True
        self._pt_first_kf[ids] = kf_id
        self._pt_last_kf[ids] = kf_id
        self._pt_nobs[ids] = 1
        self.n_pt = need
        self.pobs.append(ids, kf_id, np.asarray(fis))
        return ids

    def new_lines(self, Lw: np.ndarray, desc: np.ndarray, kf_id: int,
                  fis: np.ndarray, ep_w: np.ndarray) -> np.ndarray:
        k = len(Lw)
        if k == 0:
            return np.zeros(0, np.int64)
        need = self.n_ls + k
        self._ls_w = _grow(self._ls_w, need)
        self._ls_epw = _grow(self._ls_epw, need)
        self._ls_desc = _grow(self._ls_desc, need)
        self._ls_valid = _grow(self._ls_valid, need)
        self._ls_first_kf = _grow(self._ls_first_kf, need)
        self._ls_last_kf = _grow(self._ls_last_kf, need)
        self._ls_nobs = _grow(self._ls_nobs, need)
        ids = np.arange(self.n_ls, need)
        self._ls_w[ids] = Lw
        self._ls_epw[ids] = ep_w
        self._ls_desc[ids] = desc
        self._ls_valid[ids] = True
        self._ls_first_kf[ids] = kf_id
        self._ls_last_kf[ids] = kf_id
        self._ls_nobs[ids] = 1
        self.n_ls = need
        self.lobs.append(ids, kf_id, np.asarray(fis))
        return ids

    # -- observations + covisibility ---------------------------------------

    def _covis_delta(self, kf_id: int, observer_kfs: np.ndarray, delta: int):
        """full_graph[kf_id][obs] += delta for every observer (the
        per-shared-feature increments of mapHandler.cpp:349-350, :788-789,
        :912-913 / decrements of :2251-2252)."""
        obs = observer_kfs[observer_kfs != kf_id]
        if not len(obs):
            return
        counts = np.bincount(obs, minlength=self.covis.shape[0])
        counts = (counts * delta).astype(np.int32)
        self.covis[kf_id, :] += counts
        self.covis[:, kf_id] += counts

    def _covis_pairs(self, a: np.ndarray, b: np.ndarray, delta: int):
        """covis[a_i, b_i] += delta and covis[b_i, a_i] += delta for every
        pair, compacted to unique pairs (pairs with a == b dropped,
        matching _covis_delta's self-exclusion).  No K^2 temporaries."""
        m = a != b
        a, b = a[m], b[m]
        if not len(a):
            return
        K = self.covis.shape[0]
        uk, cnt = np.unique(a.astype(np.int64) * K + b, return_counts=True)
        ai = (uk // K).astype(np.int64)
        bi = (uk % K).astype(np.int64)
        d = (cnt * delta).astype(np.int32)
        cv = self.covis
        np.add.at(cv, (ai, bi), d)
        np.add.at(cv, (bi, ai), d)

    def add_point_obs(self, lms: np.ndarray, kf_id: int, fis: np.ndarray):
        """Add one observation per (landmark, feature) pair from kf_id,
        bumping covis against EVERY keyframe already observing each
        landmark (mapHandler.cpp:322-351)."""
        lms = np.asarray(lms, np.int64)
        fis = np.asarray(fis, np.int64)
        if not len(lms):
            return
        prior = self.pobs.rows_of(lms)
        if len(prior):
            self._covis_delta(kf_id, self.pobs.kf[prior], +1)
        self.pobs.append(lms, kf_id, fis)
        self._pt_last_kf[lms] = kf_id
        # np.add.at: fancy-index += collapses duplicate landmark ids (a
        # loop-closure merge can point two features of one KF at the same
        # landmark), desyncing nobs from the live observation rows
        np.add.at(self._pt_nobs, lms, 1)

    def add_line_obs(self, lms: np.ndarray, kf_id: int, fis: np.ndarray):
        lms = np.asarray(lms, np.int64)
        fis = np.asarray(fis, np.int64)
        if not len(lms):
            return
        prior = self.lobs.rows_of(lms)
        if len(prior):
            self._covis_delta(kf_id, self.lobs.kf[prior], +1)
        self.lobs.append(lms, kf_id, fis)
        self._ls_last_kf[lms] = kf_id
        np.add.at(self._ls_nobs, lms, 1)

    def _remove_obs_rows(self, table: _ObsTable, nobs: np.ndarray,
                         rows: np.ndarray):
        """Tombstone observation rows, decrementing covis between each
        removed observer and the other observers of its landmark (the
        pruning decrements of mapHandler.cpp:2251-2252, :6154-6293).
        Fully batched: the sequential per-row loop's net effect is one
        decrement per unordered live-row pair {removed, other} of the same
        landmark (pairs of two removed rows count once), assembled here as
        bulk pair arrays + one bincount."""
        rows = np.unique(np.asarray(rows, np.int64))
        if len(rows):
            rows = rows[table.valid[rows]]
        if not len(rows):
            return
        lms = table.lm[rows]
        order, lo, hi = table.group_slices(lms)  # per removed row's lm
        rep = hi - lo                            # full obs count of its lm
        total = int(rep.sum())
        # cartesian product: each removed row x all live rows of its lm
        block = np.cumsum(rep) - rep
        j = np.arange(total) - np.repeat(block, rep)
        left = np.repeat(rows, rep)
        right = order[np.repeat(lo, rep) + j]
        removed = np.zeros(table.n, bool)
        removed[rows] = True
        keepm = left != right
        # both-removed pairs are generated from each side; keep one
        keepm &= ~(removed[right] & (right < left))
        self._covis_pairs(table.kf[left[keepm]], table.kf[right[keepm]], -1)
        np.add.at(nobs, lms, -1)
        table.valid[rows] = False
        table._idx_remove(rows)

    def remove_point_obs_rows(self, rows: np.ndarray):
        self._remove_obs_rows(self.pobs, self._pt_nobs, rows)

    def remove_line_obs_rows(self, rows: np.ndarray):
        self._remove_obs_rows(self.lobs, self._ls_nobs, rows)

    def point_obs(self, lm: int):
        """Live (kf, feat) observation arrays of one point landmark."""
        rows = self.pobs.rows_of([lm])
        return self.pobs.kf[rows], self.pobs.fi[rows]

    def line_obs(self, lm: int):
        rows = self.lobs.rows_of([lm])
        return self.lobs.kf[rows], self.lobs.fi[rows]

    def _merge(self, table: _ObsTable, nobs: np.ndarray,
               valid_view: np.ndarray, last_kf: np.ndarray,
               keep: int, kill: int):
        """Fuse landmark ``kill`` into ``keep``: move its observation rows,
        bump covis between every (keep-observer, kill-observer) pair, and
        invalidate ``kill`` (loopClosureFuseLandmarks fuse-duplicates case,
        mapHandler.cpp:5613-5656)."""
        keep_rows = table.rows_of([keep])
        kill_rows = table.rows_of([kill])
        if len(keep_rows) and len(kill_rows):
            a = np.repeat(table.kf[kill_rows], len(keep_rows))
            b = np.tile(table.kf[keep_rows], len(kill_rows))
            self._covis_pairs(a, b, +1)
        table._idx_remove(kill_rows)
        table.lm[kill_rows] = keep
        table._idx_insert(kill_rows)
        nobs[keep] += nobs[kill]
        nobs[kill] = 0
        valid_view[kill] = False
        if len(kill_rows):
            last_kf[keep] = max(last_kf[keep], int(table.kf[kill_rows].max()))
        return kill_rows

    def merge_point_landmarks(self, keep: int, kill: int):
        """Returns the moved obs rows so the caller can re-point per-KF
        feature->landmark links."""
        return self._merge(self.pobs, self._pt_nobs,
                           self.pt_valid, self._pt_last_kf, keep, kill)

    def merge_line_landmarks(self, keep: int, kill: int):
        return self._merge(self.lobs, self._ls_nobs,
                           self.ls_valid, self._ls_last_kf, keep, kill)

    def drop_keyframe_obs(self, kf_id: int):
        """Remove every observation made by one keyframe (KF culling,
        removeRedundantKFs :3899-4047).  Covis pairs between OTHER
        keyframes are unaffected (sharing doesn't involve kf_id); the
        culled KF's row/col is cleared wholesale, matching :4036-4039.
        Landmarks ANCHORED at the culled KF (first_kf ownership — used by
        the loop-closure rigid map correction, loop.py) are rebased onto
        their oldest surviving observer, the array analog of the
        reference's ownership hand-off (:3983-4009)."""
        for table, nobs, valid_view, first_kf in (
                (self.pobs, self._pt_nobs, self.pt_valid,
                 self._pt_first_kf),
                (self.lobs, self._ls_nobs, self.ls_valid,
                 self._ls_first_kf)):
            rows = np.where(table.valid[: table.n]
                            & (table.kf[: table.n] == kf_id))[0]
            if len(rows):
                np.add.at(nobs, table.lm[rows], -1)
                table.valid[rows] = False
                table._idx_remove(rows)
            # ownership rebase: oldest surviving observer takes over
            n_lm = len(valid_view)
            owned = np.where(valid_view
                             & (first_kf[:n_lm] == kf_id))[0]
            if len(owned):
                _, lo, hi = table.group_slices(owned)
                lens = hi - lo
                live = table.rows_of(owned)
                gid = np.repeat(np.arange(len(owned)), lens)
                new_owner = np.full(len(owned), 1 << 30, np.int64)
                np.minimum.at(new_owner, gid, table.kf[live])
                has = new_owner < (1 << 30)
                first_kf[owned[has]] = new_owner[has]
        self.covis[kf_id, :] = 0
        self.covis[:, kf_id] = 0

    # -- covisibility -------------------------------------------------------

    @property
    def covis(self) -> np.ndarray:
        """(K, K) covisibility-count view (full_graph)."""
        k = len(self.keyframes)
        return self._covis_buf[:k, :k]

    @covis.setter
    def covis(self, value):
        k = len(self.keyframes)
        self._covis_buf[:k, :k] = value

    def expand_graphs(self):
        """Grow covis to (K+1)^2 (expandGraphs :992) — amortized O(1) via
        the capacity-doubling buffer; new row/col arrive zeroed."""
        k = len(self.keyframes)
        cap = self._covis_buf.shape[0]
        if k > cap:
            new = np.zeros((2 * cap, 2 * cap), np.int32)
            new[:cap, :cap] = self._covis_buf
            self._covis_buf = new
        else:
            # the freshly exposed row/col may hold counts of a previously
            # truncated map (checkpoint restore reuse) — zero them
            self._covis_buf[k - 1, :k] = 0
            self._covis_buf[:k, k - 1] = 0

    def local_kf_set(self) -> np.ndarray:
        """formLocalMap (:1005): KFs covisible with the newest (covis >=
        min_lm_cov_graph) or within the last min_kf_local_map KFs."""
        k = len(self.keyframes)
        newest = k - 1
        local = np.zeros(k, bool)
        local[max(0, k - self.cfg.min_kf_local_map):] = True
        if k > 1:
            local |= self.covis[newest] >= self.cfg.min_lm_cov_graph
        active = np.asarray([kf.active for kf in self.keyframes])
        return local & active

    # -- legacy-style accessors (tests / tools) ------------------------------

    @staticmethod
    def _obs_lists(table: _ObsTable, n_lm: int) -> list[list[tuple]]:
        order, lo, hi = table.group_slices(np.arange(n_lm))
        return [[(int(table.kf[r]), int(table.fi[r]))
                 for r in order[lo[i]: hi[i]]] for i in range(n_lm)]

    @property
    def pt_obs(self) -> list[list[tuple]]:
        """Observation lists in (kf, feat) tuple form — compatibility view
        for tests and serialization; not used on hot paths."""
        return self._obs_lists(self.pobs, self.n_pt)

    @property
    def ls_obs(self) -> list[list[tuple]]:
        return self._obs_lists(self.lobs, self.n_ls)


# ---------------------------------------------------------------------------
# Device-side helpers (jitted once per shape)
# ---------------------------------------------------------------------------


def _np_transform_plucker(T: np.ndarray, L: np.ndarray) -> np.ndarray:
    """Host-side Pluecker transform (matches core.plucker.transform_plucker:
    n' = R n + t x (R d); d' = R d).  The map-maintenance paths run this
    on small batches, where an eager device op per call would make mapping
    dispatch-bound."""
    R, t = T[:3, :3], T[:3, 3]
    n = L[..., :3] @ R.T
    d = L[..., 3:] @ R.T
    return np.concatenate([n + np.cross(np.broadcast_to(t, d.shape), d),
                           d], axis=-1)


def _np_normalize_plucker(L: np.ndarray) -> np.ndarray:
    dn = np.linalg.norm(L[..., 3:], axis=-1, keepdims=True)
    return L / np.where(dn > 1e-12, dn, 1.0)


_orth_batch = jax.jit(full_f32_matmuls(jax.vmap(plucker_to_orth)))
_plucker_from_orth_batch = jax.jit(
    full_f32_matmuls(jax.vmap(orth_to_plucker)))


def _orth_from_plucker_meta(prob, meta):
    """Host-side Pluecker -> orth fill of a chunk BAProblem whose lines
    ride ``meta['lines_plucker']`` (shared by the single-chip chunked GBA
    and the kf-block sharded GBA)."""
    lp = meta["lines_plucker"]
    if lp is None:
        return prob
    nls = len(meta["ls_ids"])
    orth = np.zeros_like(prob.lines_orth)
    if nls:
        scales = np.linalg.norm(lp[:nls], axis=-1)
        orth[:nls] = np.asarray(_orth_batch(jnp.asarray(
            (lp[:nls] / np.maximum(scales, 1e-12)[:, None]
             ).astype(np.float32))))
        prob.lines_scale[:nls] = scales
    return prob._replace(lines_orth=orth)


def _pad_bucket(n: int, lo: int = 256) -> int:
    """Round a dynamic candidate count up to a power-of-two bucket so the
    jitted matchers compile O(log N) distinct shapes instead of one fresh
    program per keyframe."""
    b = lo
    while b < n:
        b *= 2
    return b


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    if len(a) >= n:
        return a[:n]
    pad = np.zeros((n - len(a),) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad])


def _np_hamming(descs: np.ndarray) -> np.ndarray:
    """Tiny all-pairs Hamming in numpy (per-landmark descriptor election
    runs on a handful of observations; device dispatch would dominate)."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)
    return (bits[:, None, :] != bits[None, :, :]).sum(-1)



def _locked(fn):
    """Run a MapHandler method under its reentrant host-map lock: the
    mapping worker thread and outside callers (flush_ba write-back,
    trajectory reads, GBA, culling) must not mutate the obs tables
    concurrently; _ba_lock only guards the pending-handoff swap."""
    import functools

    @functools.wraps(fn)
    def inner(self, *a, **k):
        with self._map_lock:
            return fn(self, *a, **k)
    return inner


class MapHandler:
    """Host orchestrator of keyframe insertion and local BA."""

    def __init__(self, cam: StereoCamera, cfg: MapConfig = MapConfig(),
                 ba_cfg: Optional[ba_mod.BAConfig] = None,
                 tracker_cfg=None):
        self.cam = cam
        self.cfg = cfg
        self.ba_cfg = ba_cfg or ba_mod.BAConfig()
        self.tracker_cfg = tracker_cfg  # for hasRefinement; None = defaults
        self.map = SlamMap(cfg)
        self._ba_packed = jax.jit(ba_mod.bundle_adjust_packed,
                                   static_argnums=(4, 5))
        self._gba_jit = jax.jit(ba_mod.bundle_adjust_chunked,
                                static_argnums=2)
        self._refine_jit = None  # built lazily (has_refinement only)
        # deferred local-BA: the dispatched solve whose fetch/write-back is
        # postponed so it overlaps the next keyframe's association — the
        # analog of the reference's LBA-lag protocol, where write-back is
        # skipped while a KF insertion is in flight (mapHandler.cpp:2160)
        import threading

        self._ba_pending = None       # (device out, layout, meta)
        self.n_local_ba = 0           # local BA solves dispatched
        self._ba_lock = threading.Lock()
        # Serializes HOST map mutation/read between the mapping worker
        # thread and outside callers (flush_ba write-back vs an in-flight
        # keyframe insertion would otherwise tear the obs tables —
        # _ba_lock only guards the pending-handoff swap).  Reentrant:
        # add_keyframe internally calls flush_ba.
        self._map_lock = threading.RLock()

        # Fused association programs: KF2KF and Map2KF run as ONE program
        # + ONE device_get each instead of per-modality chains, so each
        # pays one dispatch and one device round trip.
        cam_, win_, nnr_ = self.cam, self.cfg.match_window, self.cfg.nnr
        use_lines_ = self.cfg.use_lines
        sim_ = self.cfg.line_sim_th
        min_pt_ = self.cfg.min_pt_matches

        def _kf2kf_prog(T_rel, pP, pdesc, pvalid, kdesc, kuv, kvalid,
                        pls_desc, pls_sp, pls_ep, pls_valid,
                        kls_desc, kls_sp, kls_ep, kls_valid):
            Pc = lie.transform_point(T_rel, pP)
            proj = cam_.project(Pc)
            ok_prev = pvalid & (Pc[..., 2] > 0)
            mask_w = M.window_pair_mask(proj, kuv, ok_prev, kvalid,
                                        win_, win_)
            m_w = M.match_descriptors(pdesc, kdesc, mask_w, nnr_)
            # global fallback candidates computed in the same pass
            mask_g = ok_prev[:, None] & kvalid[None, :]
            m_g = M.match_descriptors(pdesc, kdesc, mask_g, nnr_)
            if not use_lines_:  # static: line work dropped at trace time
                return jnp.concatenate([m_w.idx, m_g.idx])
            # full-segment candidate window + direction filter
            # (matchGrid-lines via LineIterator raster, matching.cpp:179-235)
            lmask = M.line_pair_mask(pls_sp, pls_ep, kls_sp, kls_ep,
                                     pls_valid, kls_valid, win_ * 2.0, sim_)
            m_l = M.match_descriptors(pls_desc, kls_desc, lmask, nnr_)
            return jnp.concatenate([m_w.idx, m_g.idx, m_l.idx])

        self._kf2kf_prog = jax.jit(full_f32_matmuls(_kf2kf_prog))

        def _assoc_prog(Tm, dp, dk, prev_pt_lm, prev_ls_lm,
                        cpack, dpack, cval, cand_pf, nb, nbl):
            """The WHOLE per-KF association as one device program + one
            fetch: KF2KF matching (windowed + global fallback chosen
            in-trace), the chi^2 landmark-creation gates (:489-494,
            :557-562), the free-feature sets, Map2KF matching against the
            pre-staged local-map candidates, and the packed host copy of
            the new KF's features: one association round trip per KF
            instead of three."""
            T_rel, T_c_w, T_w_prev = Tm[0], Tm[1], Tm[2]
            # ---- KF2KF points (matchKF2KFPoints :237-366) ----
            Pc = lie.transform_point(T_rel, dp.points.P)
            proj = cam_.project(Pc)
            ok_prev = dp.points.valid & (Pc[..., 2] > 0)
            mask_w = M.window_pair_mask(proj, dk.points.uv, ok_prev,
                                        dk.points.valid, win_, win_)
            m_w = M.match_descriptors(dp.points.desc, dk.points.desc,
                                      mask_w, nnr_)
            mask_g = ok_prev[:, None] & dk.points.valid[None, :]
            m_g = M.match_descriptors(dp.points.desc, dk.points.desc,
                                      mask_g, nnr_)
            # windowed -> global fallback (:277-281), decided in-trace
            idx_pt = jnp.where(jnp.sum(m_w.idx >= 0) >= min_pt_,
                               m_w.idx, m_g.idx)
            # chi^2 creation gate: reproject the would-be landmark into
            # the NEW keyframe (:489-494)
            Pw = lie.transform_point(T_w_prev, dp.points.P)
            Pc2 = lie.transform_point(T_c_w, Pw)
            proj2 = cam_.project(Pc2)
            tgt = dk.points.uv[jnp.maximum(idx_pt, 0)]
            e2 = jnp.sum((proj2 - tgt) ** 2, axis=-1)
            chi_pt = (Pc2[..., 2] > 0) & (e2 <= CHI2_GATE * 4.0)
            acc_pt = (idx_pt >= 0) & ((prev_pt_lm >= 0) | chi_pt)
            nk = dk.points.uv.shape[0]
            taken = jnp.zeros(nk, jnp.int32).at[
                jnp.maximum(idx_pt, 0)].add(acc_pt.astype(jnp.int32)) > 0
            kfree = dk.points.valid & ~taken
            if use_lines_:
                # ---- KF2KF lines (matchKF2KFLines :368-590) ----
                # full-segment window + direction filter (matchGrid-lines
                # via LineIterator raster, matching.cpp:179-235)
                lmask = M.line_pair_mask(dp.lines.sp, dp.lines.ep,
                                         dk.lines.sp, dk.lines.ep,
                                         dp.lines.valid, dk.lines.valid,
                                         win_ * 2.0, sim_)
                m_l = M.match_descriptors(dp.lines.desc, dk.lines.desc,
                                          lmask, nnr_)
                # line chi^2 gate: lift to world (renormalized :451-459),
                # project into the new KF, endpoint-to-line errors
                from ..core.plucker import normalize_plucker
                Lw = normalize_plucker(
                    transform_plucker(T_w_prev, dp.lines.NDc))
                Lc = transform_plucker(T_c_w, Lw)
                l2 = cam_.project_line(Lc)
                nrm = jnp.hypot(l2[..., 0], l2[..., 1])
                good = nrm > 1e-9
                nrm = jnp.where(good, nrm, 1.0)
                safe_l = jnp.maximum(m_l.idx, 0)
                spt = dk.lines.sp[safe_l]
                ept = dk.lines.ep[safe_l]
                e0 = (l2[..., 0] * spt[..., 0] + l2[..., 1] * spt[..., 1]
                      + l2[..., 2]) / nrm
                e1 = (l2[..., 0] * ept[..., 0] + l2[..., 1] * ept[..., 1]
                      + l2[..., 2]) / nrm
                chi_ls = good & (e0 * e0 + e1 * e1 <= CHI2_GATE * 4.0)
                acc_ls = (m_l.idx >= 0) & ((prev_ls_lm >= 0) | chi_ls)
                nkl = dk.lines.sp.shape[0]
                ltaken = jnp.zeros(nkl, jnp.int32).at[safe_l].add(
                    acc_ls.astype(jnp.int32)) > 0
                kls_free = dk.lines.valid & ~ltaken
                kf_buf = jnp.concatenate([
                    idx_pt.astype(jnp.float32), chi_pt.astype(jnp.float32),
                    m_l.idx.astype(jnp.float32),
                    chi_ls.astype(jnp.float32)])
            else:
                kls_free = jnp.zeros(dk.lines.sp.shape[0], bool)
                acc_ls = None
                kf_buf = jnp.concatenate([
                    idx_pt.astype(jnp.float32), chi_pt.astype(jnp.float32)])
            # ---- Map2KF against the pre-staged candidates; exclude
            # candidates just re-observed through KF2KF ----
            pf = cand_pf[:nb]
            cand_valid = cval[:nb] & ~((pf >= 0)
                                       & acc_pt[jnp.maximum(pf, 0)])
            if use_lines_:
                pfl = cand_pf[nb:]
                lcand_valid = cval[nb:] & ~((pfl >= 0)
                                            & acc_ls[jnp.maximum(pfl, 0)])
            else:
                lcand_valid = cval[nb:]
            m2_buf = _map2kf_core(T_c_w, cpack, dpack, cand_valid,
                                  lcand_valid, kfree, kls_free,
                                  dk.points.desc, dk.points.uv,
                                  dk.lines.sp, dk.lines.ep, dk.lines.desc,
                                  nb, nbl)
            # ONE output buffer: one device->host fetch per KF
            return jnp.concatenate([kf_buf, m2_buf, _pack_feats(dk)])

        self._assoc_prog = jax.jit(full_f32_matmuls(_assoc_prog),
                                   static_argnums=(9, 10))

        def _line_eq(sp, ep):
            # normalized image-line equation through two 2D points
            l = jnp.cross(
                jnp.concatenate([sp, jnp.ones_like(sp[..., :1])], -1),
                jnp.concatenate([ep, jnp.ones_like(ep[..., :1])], -1))
            nrm = jnp.hypot(l[..., 0], l[..., 1])
            return l / jnp.maximum(nrm, 1e-9)[..., None]

        def _map2kf_core(T_c_w, cpack, dpack, cand_valid, lcand_valid,
                         kfree, kls_free,
                         kdesc, kuv, kls_sp, kls_ep, kls_desc, nb, nbl):
            candP = cpack[:nb]
            cand_sPw = cpack[nb:nb + nbl]
            cand_ePw = cpack[nb + nbl:]
            cand_desc = dpack[:nb]
            lcand_desc = dpack[nb:]
            # -- points (matchMap2KFPoints :697-797) --
            Pc = lie.transform_point(T_c_w, candP)
            proj = cam_.project(Pc)
            inside = (cand_valid & (Pc[..., 2] > 0)
                      & (proj[..., 0] >= 0) & (proj[..., 0] < cam_.width)
                      & (proj[..., 1] >= 0) & (proj[..., 1] < cam_.height))
            mask = M.window_pair_mask(proj, kuv, inside, kfree, win_, win_)
            m = M.match_descriptors(cand_desc, kdesc, mask, nnr_)
            # projected distance per accepted pair (epipolar gate :778)
            safe = jnp.maximum(m.idx, 0)
            p_err = jnp.linalg.norm(proj - kuv[safe], axis=-1)
            if not use_lines_:
                return jnp.concatenate([m.idx.astype(jnp.float32), p_err])
            # -- lines (matchMap2KFLines :799-921): project world
            # endpoints, inside-image gate, full-segment grid window +
            # direction cosine filter, mutual NNR, and the
            # endpoint-to-observed-line epipolar errors --
            sPc = lie.transform_point(T_c_w, cand_sPw)
            ePc = lie.transform_point(T_c_w, cand_ePw)
            spf = cam_.project(sPc)
            epf = cam_.project(ePc)

            def _in(p, z):
                return ((z > 0) & (p[..., 0] >= 0) & (p[..., 0] < cam_.width)
                        & (p[..., 1] >= 0) & (p[..., 1] < cam_.height))

            l_inside = (lcand_valid & _in(spf, sPc[..., 2])
                        & _in(epf, ePc[..., 2]))
            v1 = epf - spf
            v2 = kls_ep - kls_sp
            n1 = jnp.maximum(jnp.linalg.norm(v1, axis=-1, keepdims=True), 1e-9)
            n2 = jnp.maximum(jnp.linalg.norm(v2, axis=-1, keepdims=True), 1e-9)
            cos = jnp.abs((v1 / n1) @ (v2 / n2).T)
            # full-segment proximity of the projected landmark segment to
            # the detected segment (matchGrid-lines raster parity)
            near = M.segment_window_mask(spf, epf, kls_sp, kls_ep,
                                         win_ * 2.0)
            wmask = (near & l_inside[:, None] & kls_free[None, :])
            lmask = wmask & (cos >= sim_)
            m_l = M.match_descriptors(lcand_desc, kls_desc, lmask, nnr_)
            # global fallback (match() path :875-878): validity-only mask
            gmask = (l_inside[:, None] & kls_free[None, :]) & (cos >= sim_)
            m_lg = M.match_descriptors(lcand_desc, kls_desc, gmask, nnr_)
            # epipolar errors of both candidates' picks vs the observed
            # feature line (err = l_obs . [proj; 1], :889-894)
            le = _line_eq(kls_sp, kls_ep)

            def _errs(idx):
                lsel = le[jnp.maximum(idx, 0)]
                e_s = jnp.abs(lsel[..., 0] * spf[..., 0]
                              + lsel[..., 1] * spf[..., 1] + lsel[..., 2])
                e_e = jnp.abs(lsel[..., 0] * epf[..., 0]
                              + lsel[..., 1] * epf[..., 1] + lsel[..., 2])
                return jnp.maximum(e_s, e_e)

            return jnp.concatenate([
                m.idx.astype(jnp.float32), p_err,
                m_l.idx.astype(jnp.float32), m_lg.idx.astype(jnp.float32),
                _errs(m_l.idx), _errs(m_lg.idx)])

        def _map2kf_prog(T_c_w, cpack, dpack, vpack,
                         kdesc, kuv, kls_sp, kls_ep, kls_desc, nb, nbl):
            nk = kdesc.shape[0]
            return _map2kf_core(
                T_c_w, cpack, dpack, vpack[:nb], vpack[nb:nb + nbl],
                vpack[nb + nbl:nb + nbl + nk], vpack[nb + nbl + nk:],
                kdesc, kuv, kls_sp, kls_ep, kls_desc, nb, nbl)

        self._map2kf_prog = jax.jit(full_f32_matmuls(_map2kf_prog),
                                    static_argnums=(9, 10))

    # -- public API (mapHandler.cpp initialize :50 / addKeyFrame :121) ----

    @_locked
    def initialize(self, pose: np.ndarray, feats: StereoFeatures):
        kf = KeyframeRecord(0, pose, feats)
        kf.T_vo = kf.T_w_k.copy()
        self.map.keyframes.append(kf)
        self.map.expand_graphs()
        # every stereo feature of KF0 seeds a landmark (reference behavior:
        # initial KF features become the initial map)
        self._spawn_landmarks(kf)

    def _trim_device_cache(self, keep_last: int = 2):
        """Drop device-resident feature pytrees of old keyframes.

        Association only ever reads the previous/current records'
        dev_feats(); keeping every record's pytree alive pins
        O(keyframes) HBM (hundreds of KB per KF — unbounded growth on
        long runs).  dev_feats() rebuilds from the host copy on demand
        (e.g. a loop-closure candidate), so dropping is safe."""
        for rec in self.map.keyframes[:-keep_last]:
            rec.dev = None

    @_locked
    def add_keyframe(self, pose: np.ndarray, feats: StereoFeatures,
                     run_ba: bool = True, defer_ba: bool = False):
        """Insert one keyframe.  ``pose`` is the front-end's (VO) pose;
        the map pose is CHAINED through the previous keyframe's optimized
        pose (T_curr_w = T_prev * T_rel, addKeyFrame :162) so BA and
        loop-closure corrections propagate to subsequent keyframes."""
        self._trim_device_cache()
        if self.cfg.has_refinement:
            # refinement re-optimizes the pose BETWEEN the KF2KF and
            # Map2KF passes (:937-977), so the association cannot fuse
            # into one program — use the split three-dispatch path
            self.flush_ba()
            pose_vo = np.asarray(pose, np.float64)
            prev = self.map.keyframes[-1]
            rel = np.linalg.inv(getattr(prev, "T_vo", prev.T_w_k)) @ pose_vo
            kf = KeyframeRecord(len(self.map.keyframes),
                                prev.T_w_k @ rel, feats)
            kf.T_vo = pose_vo
            self.map.keyframes.append(kf)
            self.map.expand_graphs()
            self._match_kf2kf(kf)
            self._refine_kf_pose(kf)
            self._match_map2kf(kf)
        else:
            kf = self._associate_and_insert(pose, feats)
        self._spawn_landmarks(kf)  # leftovers become new landmarks
        if run_ba:
            self.local_bundle_adjustment(defer=defer_ba)
        self.cull_landmarks()
        if (self.cfg.desc_refresh_kfs > 0 and kf.id > 0
                and kf.id % self.cfg.desc_refresh_kfs == 0):
            # periodic batched re-election so representative descriptors
            # track viewpoint drift (updateAverageDescDir semantics)
            self.refresh_landmark_descriptors()
        if (self.cfg.cull_kf_every > 0
                and kf.id % self.cfg.cull_kf_every == 0):
            self.flush_ba()
            self.cull_redundant_keyframes(self.cfg.max_common_fts_kf)
        return kf

    def _associate_and_insert(self, pose: np.ndarray,
                              feats: StereoFeatures) -> KeyframeRecord:
        """Insert a keyframe with the WHOLE association (KF2KF + Map2KF +
        chi^2 gates + packed host copy) as one device dispatch + one
        fetch.  Map2KF candidates come from the local map as formed after
        the PREVIOUS keyframe — the reference's order as well: its
        matchMap2KF passes run before formLocalMap updates the local set
        (mapHandler.cpp:923-990, :1005)."""
        mp = self.map
        cfg = self.cfg
        prev = mp.keyframes[-1]
        pose_vo = np.asarray(pose, np.float64)
        # chain through the previous keyframe's optimized pose (:162);
        # provisional if a deferred BA is still in flight — re-chained
        # after the combined fetch below
        rel = np.linalg.inv(getattr(prev, "T_vo", prev.T_w_k)) @ pose_vo
        pose = prev.T_w_k @ rel
        T_c_w_new = np.linalg.inv(pose)
        Tm = np.stack([T_c_w_new @ prev.T_w_k,   # prev-cam -> new-cam
                       T_c_w_new, prev.T_w_k]).astype(np.float32)

        local_kf = mp.local_kf_set()
        cand = np.where(
            mp.pt_valid
            & self._local_landmark_mask(mp.pobs, mp.n_pt, local_kf))[0]
        if cfg.use_lines:
            cand_l = np.where(
                mp.ls_valid
                & self._local_landmark_mask(mp.lobs, mp.n_ls, local_kf))[0]
        else:
            cand_l = np.zeros(0, np.int64)
        nb = _pad_bucket(len(cand))
        nbl = _pad_bucket(len(cand_l), lo=64)
        cpack = np.zeros((nb + 2 * nbl, 3), np.float32)
        cpack[:nb] = _pad_rows(mp.pt_w[cand], nb)
        cpack[nb:nb + nbl] = _pad_rows(mp.ls_epw[cand_l, 0], nbl)
        cpack[nb + nbl:] = _pad_rows(mp.ls_epw[cand_l, 1], nbl)
        dpack = np.zeros((nb + nbl, 8), np.uint32)
        dpack[:nb] = _pad_rows(mp.pt_desc[cand], nb)
        dpack[nb:] = _pad_rows(mp.ls_desc[cand_l], nbl)
        cval = np.zeros(nb + nbl, bool)
        cval[:nb] = np.arange(nb) < len(cand)
        cval[nb:] = np.arange(nbl) < len(cand_l)
        # candidate -> prev-KF feature index (so the program can exclude
        # candidates that KF2KF just re-observed)
        pf = np.full(nb + nbl, -1, np.int32)
        w = prev.pt_lm >= 0
        inv = np.full(mp.n_pt, -1, np.int64)
        inv[prev.pt_lm[w]] = np.where(w)[0]
        pf[:len(cand)] = inv[cand]
        if cfg.use_lines and len(cand_l):
            wl = prev.ls_lm >= 0
            inv_l = np.full(mp.n_ls, -1, np.int64)
            inv_l[prev.ls_lm[wl]] = np.where(wl)[0]
            pf[nb:nb + len(cand_l)] = inv_l[cand_l]

        dp, dk = prev.dev_feats(), feats
        out = self._assoc_prog(
            jnp.asarray(Tm), dp, dk,
            jnp.asarray(prev.pt_lm, jnp.int32),
            jnp.asarray(prev.ls_lm, jnp.int32),
            jnp.asarray(cpack), jnp.asarray(dpack), jnp.asarray(cval),
            jnp.asarray(pf), nb, nbl)
        # fetch together with any deferred local-BA result: the pending
        # solve (dispatched by the previous add_keyframe) completed while
        # the tracker produced this KF, so ONE sync covers both
        buf = self._fetch_with_pending(out)
        n, nl = len(prev.pt_valid), len(prev.ls_valid)
        nk2 = 2 * n + (2 * nl if cfg.use_lines else 0)
        nm2 = 2 * nb + (4 * nbl if cfg.use_lines else 0)
        kf_buf = buf[:nk2]
        m2_buf = buf[nk2: nk2 + nm2]
        packed = buf[nk2 + nm2:]

        # the combined fetch may have applied a deferred BA that moved
        # prev's pose — re-chain so the new KF rides the optimized chain
        # (the in-program gates used the provisional pose; their chi^2
        # slack absorbs the one-solve delta, like the reference's
        # write-back-lag protocol, mapHandler.cpp:2160)
        pose = prev.T_w_k @ rel
        kf = KeyframeRecord(len(mp.keyframes), pose, feats, packed=packed)
        kf.T_vo = pose_vo
        mp.keyframes.append(kf)
        mp.expand_graphs()

        idx_pt = kf_buf[:n].astype(np.int64)
        chi_pt = kf_buf[n: 2 * n] > 0.5
        self._apply_kf2kf_points(kf, prev, idx_pt, chi_pt)
        if cfg.use_lines:
            idx_l = kf_buf[2 * n: 2 * n + nl].astype(np.int64)
            chi_ls = kf_buf[2 * n + nl:] > 0.5
            self._apply_kf2kf_lines(kf, prev, idx_l, chi_ls)
        self._apply_map2kf(kf, cand, cand_l, m2_buf, nb, nbl)
        return kf

    # -- association ------------------------------------------------------

    def _match_kf2kf(self, kf: KeyframeRecord):
        """Project the previous KF's features into the new KF and match
        (matchKF2KFPoints :237 / Lines :368).  Fully batched: one device
        program, then numpy-batched landmark creation / observation adds."""
        prev = self.map.keyframes[-2]
        mp = self.map
        T_c_w_new = np.linalg.inv(kf.T_w_k)
        T_rel = T_c_w_new @ prev.T_w_k  # prev-cam -> new-cam

        # one device program + one fetch for both modalities; feature
        # arrays are device-resident (KeyframeRecord.dev) — only the 4x4
        # relative pose is uploaded
        dp, dk = prev.dev_feats(), kf.dev_feats()
        buf = np.asarray(jax.device_get(self._kf2kf_prog(
            jnp.asarray(T_rel, jnp.float32), dp.points.P,
            dp.points.desc, dp.points.valid,
            dk.points.desc, dk.points.uv, dk.points.valid,
            dp.lines.desc, dp.lines.sp, dp.lines.ep, dp.lines.valid,
            dk.lines.desc, dk.lines.sp, dk.lines.ep, dk.lines.valid)))
        n = len(prev.pt_valid)
        idx_w, idx_g = buf[:n], buf[n: 2 * n]
        idx_l = buf[2 * n:] if self.cfg.use_lines else None
        # windowed -> global fallback when too few matches (:277-281)
        idx = idx_w if (idx_w >= 0).sum() >= self.cfg.min_pt_matches else idx_g
        self._apply_kf2kf_points(kf, prev, idx.astype(np.int64))
        if self.cfg.use_lines:
            self._apply_kf2kf_lines(kf, prev, idx_l.astype(np.int64))

    def _apply_kf2kf_points(self, kf: KeyframeRecord, prev: KeyframeRecord,
                            idx: np.ndarray, chi: np.ndarray | None = None):
        """Host table updates for the KF2KF point matches: extend existing
        landmarks, create new ones gated by the reprojection chi^2
        (:489-494; ``chi`` carries the in-program gate of the fused path,
        None recomputes it on host)."""
        mp = self.map
        i1 = np.where(idx >= 0)[0]
        i2 = idx[i1].astype(np.int64)
        lm = prev.pt_lm[i1]
        has = lm >= 0
        n1, n2 = i1[~has], i2[~has]
        R, t = prev.T_w_k[:3, :3], prev.T_w_k[:3, 3]
        Pw = prev.pt_P[n1] @ R.T + t
        ok = chi[n1] if chi is not None else self._point_chi2_ok(Pw, kf, n2)
        ids = mp.new_points(Pw[ok], prev.pt_desc[n1[ok]], prev.id, n1[ok])
        prev.pt_lm[n1[ok]] = ids
        all_lms = np.concatenate([lm[has], ids])
        all_fis = np.concatenate([i2[has], n2[ok]])
        mp.add_point_obs(all_lms, kf.id, all_fis)
        kf.pt_lm[all_fis] = all_lms

    def _apply_kf2kf_lines(self, kf: KeyframeRecord, prev: KeyframeRecord,
                           idx_l: np.ndarray, chi: np.ndarray | None = None):
        mp = self.map
        R, t = prev.T_w_k[:3, :3], prev.T_w_k[:3, 3]
        i1 = np.where(idx_l >= 0)[0]
        i2 = idx_l[i1].astype(np.int64)
        lm = prev.ls_lm[i1]
        has = lm >= 0
        n1, n2 = i1[~has], i2[~has]
        # lift the prev-KF camera-frame Pluecker lines to world and
        # renormalize ||d||=1 (mapHandler.cpp:451-459)
        Lw = _np_normalize_plucker(
            _np_transform_plucker(prev.T_w_k, prev.ls_NDc[n1]))
        ok = chi[n1] if chi is not None else self._line_chi2_ok(Lw, kf, n2)
        ep_w = np.stack([prev.ls_sP[n1[ok]] @ R.T + t,
                         prev.ls_eP[n1[ok]] @ R.T + t], axis=1)
        ids = mp.new_lines(Lw[ok], prev.ls_desc[n1[ok]], prev.id, n1[ok],
                           ep_w)
        prev.ls_lm[n1[ok]] = ids
        all_lms = np.concatenate([lm[has], ids])
        all_fis = np.concatenate([i2[has], n2[ok]])
        mp.add_line_obs(all_lms, kf.id, all_fis)
        kf.ls_lm[all_fis] = all_lms

    def _refine_kf_pose(self, kf: KeyframeRecord):
        """hasRefinement (:937-977): re-run the StVO robust pose optimizer
        on the KF pair and overwrite the new KF's pose with the result."""
        from ..frontend.features import TrackedLines, TrackedPoints
        from ..frontend.tracker import TrackerConfig, optimize_pose

        prev = self.map.keyframes[-2]
        if self._refine_jit is None:
            tcfg = self.tracker_cfg or TrackerConfig()
            tcfg = tcfg._replace(plucker_lines=self.cfg.plucker_lines,
                                 use_lines=self.cfg.use_lines)
            self._refine_jit = jax.jit(full_f32_matmuls(
                lambda p, l, cam: optimize_pose(p, l, cam, tcfg)))

        # correspondences: the landmark links just made by _match_kf2kf
        # (prev feature i1 and kf feature i2 share kf.pt_lm/ls_lm) —
        # joined through a landmark->new-feature inverse table, no
        # per-feature Python loops
        mp = self.map
        n = len(prev.pt_valid)
        obs = np.zeros((n, 2), np.float32)
        inv = np.full(max(mp.n_pt, 1), -1, np.int64)
        w2 = kf.pt_lm >= 0
        inv[kf.pt_lm[w2]] = np.where(w2)[0]
        lm1 = prev.pt_lm
        val = (lm1 >= 0) & (inv[np.maximum(lm1, 0)] >= 0)
        obs[val] = kf.pt_uv[inv[lm1[val]]]
        pts = TrackedPoints(
            P=jnp.asarray(prev.pt_P), obs=jnp.asarray(obs),
            sigma2=jnp.asarray(prev.pt_sigma2),
            valid=jnp.asarray(val), inlier=jnp.asarray(val))

        nl = len(prev.ls_valid)
        sobs = np.zeros((nl, 2), np.float32)
        eobs = np.zeros((nl, 2), np.float32)
        le = np.zeros((nl, 3), np.float32)
        inv_l = np.full(max(mp.n_ls, 1), -1, np.int64)
        w2 = kf.ls_lm >= 0
        inv_l[kf.ls_lm[w2]] = np.where(w2)[0]
        lm1 = prev.ls_lm
        lval = (lm1 >= 0) & (inv_l[np.maximum(lm1, 0)] >= 0)
        i2s = inv_l[lm1[lval]]
        sp, ep = kf.ls_sp[i2s], kf.ls_ep[i2s]
        lo = np.cross(np.concatenate([sp, np.ones((len(sp), 1))], 1),
                      np.concatenate([ep, np.ones((len(ep), 1))], 1))
        nrm = np.hypot(lo[:, 0], lo[:, 1])
        ok = nrm > 1e-9
        idx1 = np.where(lval)[0][ok]
        sobs[idx1], eobs[idx1] = sp[ok], ep[ok]
        le[idx1] = lo[ok] / nrm[ok, None]
        lval = np.zeros(nl, bool)
        lval[idx1] = True
        ls = TrackedLines(
            sP=jnp.asarray(prev.ls_sP), eP=jnp.asarray(prev.ls_eP),
            sp=jnp.asarray(prev.ls_sp), ep=jnp.asarray(prev.ls_ep),
            NDc=jnp.asarray(prev.ls_NDc), sobs=jnp.asarray(sobs),
            eobs=jnp.asarray(eobs), le_obs=jnp.asarray(le),
            sigma2=jnp.asarray(prev.ls_sigma2),
            valid=jnp.asarray(lval), inlier=jnp.asarray(lval))

        est, pts_out, ls_out = self._refine_jit(pts, ls, self.cam)
        # acceptance (:952-967): per-modality inlier ratio must reach
        # kf_inlier_ratio and total inliers must exceed min_features,
        # else the KF keeps the chained VO pose
        inl_pt = int(np.asarray(pts_out.inlier).sum())
        inl_ls = int(np.asarray(ls_out.inlier).sum())
        r_pt = 100.0 * inl_pt / max(int(val.sum()), 1)
        r_ls = 100.0 * inl_ls / max(int(lval.sum()), 1)
        cond = r_pt >= self.cfg.kf_inlier_ratio
        if self.cfg.use_lines and lval.any():
            cond = cond and r_ls >= self.cfg.kf_inlier_ratio
        if (bool(est.good) and cond
                and inl_pt + inl_ls > self.cfg.min_features):
            DT = np.asarray(est.DT, np.float64)  # new-cam <- prev-cam
            kf.T_w_k = prev.T_w_k @ np.linalg.inv(DT)

    def _local_landmark_mask(self, table: _ObsTable, n_lm: int,
                             local_kf: np.ndarray) -> np.ndarray:
        """Landmarks observed by at least one local keyframe — one
        vectorized pass over the flat obs table (formLocalMap landmark
        marking :1052-1118)."""
        sel = table.valid[: table.n] & local_kf[table.kf[: table.n]]
        mask = np.zeros(n_lm, bool)
        mask[table.lm[: table.n][sel]] = True
        return mask

    def _match_map2kf(self, kf: KeyframeRecord):
        """Track local-map landmarks not yet matched into the new KF
        (matchMap2KFPoints :697 / Lines :799)."""
        local_kf = self.map.local_kf_set()
        mp = self.map
        cfg = self.cfg
        T_c_w = np.linalg.inv(kf.T_w_k)
        # candidate landmarks: local, valid, not already observed in kf
        in_kf = np.zeros(mp.n_pt, bool)
        in_kf[kf.pt_lm[kf.pt_lm >= 0]] = True
        cand = np.where(mp.pt_valid
                        & self._local_landmark_mask(mp.pobs, mp.n_pt, local_kf)
                        & ~in_kf)[0]
        use_lines = cfg.use_lines
        if use_lines:
            in_kf_l = np.zeros(mp.n_ls, bool)
            in_kf_l[kf.ls_lm[kf.ls_lm >= 0]] = True
            cand_l = np.where(
                mp.ls_valid
                & self._local_landmark_mask(mp.lobs, mp.n_ls, local_kf)
                & ~in_kf_l)[0]
        else:
            cand_l = np.zeros(0, np.int64)
        if not len(cand) and not len(cand_l):
            return

        # one fused program + one fetch for both modalities
        nb = _pad_bucket(len(cand))
        nbl = _pad_bucket(len(cand_l), lo=64)
        free = kf.pt_valid & (kf.pt_lm < 0)
        free_l = kf.ls_valid & (kf.ls_lm < 0)
        dk = kf.dev_feats()
        # pack the candidate-landmark payload into one f32 block + one
        # desc block + one valid block (3 uploads instead of 8)
        cpack = np.zeros((nb + 2 * nbl, 3), np.float32)
        cpack[:nb] = _pad_rows(mp.pt_w[cand], nb)
        cpack[nb:nb + nbl] = _pad_rows(mp.ls_epw[cand_l, 0], nbl)
        cpack[nb + nbl:] = _pad_rows(mp.ls_epw[cand_l, 1], nbl)
        dpack = np.zeros((nb + nbl, 8), np.uint32)
        dpack[:nb] = _pad_rows(mp.pt_desc[cand], nb)
        dpack[nb:] = _pad_rows(mp.ls_desc[cand_l], nbl)
        vpack = np.zeros(nb + nbl + len(free) + len(free_l), bool)
        vpack[:nb] = np.arange(nb) < len(cand)
        vpack[nb:nb + nbl] = np.arange(nbl) < len(cand_l)
        vpack[nb + nbl:nb + nbl + len(free)] = free
        vpack[nb + nbl + len(free):] = free_l
        buf = np.asarray(jax.device_get(self._map2kf_prog(
            jnp.asarray(T_c_w, jnp.float32),
            jnp.asarray(cpack), jnp.asarray(dpack), jnp.asarray(vpack),
            dk.points.desc, dk.points.uv,
            dk.lines.sp, dk.lines.ep, dk.lines.desc, nb, nbl)))
        self._apply_map2kf(kf, cand, cand_l, buf, nb, nbl)

    def _apply_map2kf(self, kf: KeyframeRecord, cand: np.ndarray,
                      cand_l: np.ndarray, buf: np.ndarray, nb: int,
                      nbl: int):
        """Host table updates from the fetched Map2KF result buffer."""
        mp = self.map
        cfg = self.cfg
        idx = buf[:nb].astype(np.int64)
        p_err = buf[nb: 2 * nb]
        if cfg.use_lines:
            idx_l = buf[2 * nb: 2 * nb + nbl].astype(np.int64)
            idx_lg = buf[2 * nb + nbl: 2 * nb + 2 * nbl].astype(np.int64)
            l_errs = (buf[2 * nb + 2 * nbl: 2 * nb + 3 * nbl],
                      buf[2 * nb + 3 * nbl:])
        if len(cand):
            idx = idx[: len(cand)].astype(np.int64)
            p_err = p_err[: len(cand)]
            # epipolar-style gate: projected distance (:778)
            acc = (idx >= 0) & (p_err <= cfg.match_window)
            mp.add_point_obs(cand[acc], kf.id, idx[acc])
            kf.pt_lm[idx[acc]] = cand[acc]

        if len(cand_l):
            # windowed -> global fallback when too few matches (:875-878)
            nw = int((idx_l[: len(cand_l)] >= 0).sum())
            if nw >= cfg.min_ls_matches:
                lidx, lerr = idx_l, l_errs[0]
            else:
                lidx, lerr = idx_lg, l_errs[1]
            lidx = lidx[: len(cand_l)].astype(np.int64)
            lerr = lerr[: len(cand_l)]
            # epipolar gate at maxKFEpipL (:889-894; abs of the signed
            # endpoint-to-line errors)
            acc = (lidx >= 0) & (lerr < cfg.max_kf_epip_l)
            mp.add_line_obs(cand_l[acc], kf.id, lidx[acc])
            kf.ls_lm[lidx[acc]] = cand_l[acc]

    def _spawn_landmarks(self, kf: KeyframeRecord):
        """Unmatched stereo features of the newest KF seed new landmarks
        (batched; matchKF2KF* landmark creation for the leftovers)."""
        mp = self.map
        R, t = kf.T_w_k[:3, :3], kf.T_w_k[:3, 3]
        fis = np.where(kf.pt_valid & (kf.pt_lm < 0))[0]
        if len(fis):
            Pw = kf.pt_P[fis] @ R.T + t
            kf.pt_lm[fis] = mp.new_points(Pw, kf.pt_desc[fis], kf.id, fis)
        if self.cfg.use_lines:
            fis = np.where(kf.ls_valid & (kf.ls_lm < 0))[0]
            if len(fis):
                Lw = _np_normalize_plucker(
                    _np_transform_plucker(kf.T_w_k, kf.ls_NDc[fis]))
                ep_w = np.stack([kf.ls_sP[fis] @ R.T + t,
                                 kf.ls_eP[fis] @ R.T + t], axis=1)
                kf.ls_lm[fis] = mp.new_lines(Lw, kf.ls_desc[fis], kf.id,
                                             fis, ep_w)

    def _point_chi2_ok(self, Pw: np.ndarray, kf: KeyframeRecord,
                       feat_idx: np.ndarray) -> np.ndarray:
        """Batched reprojection chi^2 creation gate (:489-494)."""
        if not len(Pw):
            return np.zeros(0, bool)
        T_c_w = np.linalg.inv(kf.T_w_k)
        Pc = Pw @ T_c_w[:3, :3].T + T_c_w[:3, 3]
        z = np.maximum(Pc[:, 2], 1e-9)
        fx, fy = float(self.cam.fx), float(self.cam.fy)
        cx, cy = float(self.cam.cx), float(self.cam.cy)
        u = cx + fx * Pc[:, 0] / z
        v = cy + fy * Pc[:, 1] / z
        err = np.stack([u, v], -1) - kf.pt_uv[feat_idx]
        return (Pc[:, 2] > 0) & ((err * err).sum(-1) <= CHI2_GATE * 4.0)

    def _line_chi2_ok(self, Lw: np.ndarray, kf: KeyframeRecord,
                      feat_idx: np.ndarray) -> np.ndarray:
        if not len(Lw):
            return np.zeros(0, bool)
        T_c_w = np.linalg.inv(kf.T_w_k)
        Lc = _np_transform_plucker(T_c_w, Lw)
        K_L = np.asarray(self.cam.plucker_K)
        l = Lc[:, :3] @ K_L.T
        nrm = np.hypot(l[:, 0], l[:, 1])
        good = nrm > 1e-9
        nrm = np.where(good, nrm, 1.0)
        sp, ep = kf.ls_sp[feat_idx], kf.ls_ep[feat_idx]
        e0 = (l[:, 0] * sp[:, 0] + l[:, 1] * sp[:, 1] + l[:, 2]) / nrm
        e1 = (l[:, 0] * ep[:, 0] + l[:, 1] * ep[:, 1] + l[:, 2]) / nrm
        return good & (e0 * e0 + e1 * e1 <= CHI2_GATE * 4.0)

    # -- bundle adjustment -------------------------------------------------

    def _assemble_problem(self, local_ids: list[int], pt_ids: np.ndarray,
                          ls_ids: np.ndarray, cap_pts: int, cap_ls: int,
                          cap_pobs: int, cap_lobs: int,
                          fix_rule: str = "local",
                          cap_k: int | None = None):
        """Build one padded BAProblem over the given keyframes/landmarks —
        the array-ized localBundleAdjustmentForPlukerWithG2O graph build
        (:5870-6049).  Vectorized over the flat observation tables.

        fix_rule: 'local' fixes the oldest local KF + KF0 (LBA gauge);
        'kf0' fixes only KF0 (GBA, :3022)."""
        cfg = self.cfg
        mp = self.map
        # pad the pose axis to a STATIC capacity: a dynamic K recompiles
        # the jitted BA every time the local window grows
        K = cap_k if cap_k is not None else max(len(local_ids), 1)
        slot_of_kf = np.full(len(mp.keyframes), -1, np.int64)
        slot_of_kf[local_ids] = np.arange(len(local_ids))

        dtype = np.float32
        T = np.tile(np.eye(4, dtype=dtype), (K, 1, 1))
        pose_valid = np.zeros(K, bool)
        pose_fixed = np.zeros(K, bool)
        for s, kfid in enumerate(local_ids):
            T[s] = np.linalg.inv(mp.keyframes[kfid].T_w_k)
            pose_valid[s] = True
            if fix_rule == "local":
                pose_fixed[s] = kfid == local_ids[0] or kfid == 0
            else:
                pose_fixed[s] = kfid == 0

        # stacked per-KF feature lookups for the local set (all KF records
        # share the frontend's fixed feature capacity)
        kf_pt_uv = np.stack([mp.keyframes[k].pt_uv for k in local_ids])
        kf_pt_sig = np.stack([mp.keyframes[k].pt_sigma2 for k in local_ids])
        kf_ls_sp = np.stack([mp.keyframes[k].ls_sp for k in local_ids])
        kf_ls_ep = np.stack([mp.keyframes[k].ls_ep for k in local_ids])
        kf_ls_sig = np.stack([mp.keyframes[k].ls_sigma2 for k in local_ids])

        pslot = np.full(mp.n_pt, -1, np.int64)
        pslot[pt_ids] = np.arange(len(pt_ids))
        lslot = np.full(mp.n_ls, -1, np.int64)
        lslot[ls_ids] = np.arange(len(ls_ids))

        points = np.zeros((cap_pts, 3), dtype)
        point_valid = np.zeros(cap_pts, bool)
        points[: len(pt_ids)] = mp.pt_w[pt_ids]
        point_valid[: len(pt_ids)] = True

        lines_orth = np.zeros((cap_ls, 4), dtype)
        lines_scale = np.ones(cap_ls, dtype)
        line_valid = np.zeros(cap_ls, bool)
        lines_plucker = None
        ep_base = len(pt_ids)  # first endpoint slot in the point table
        if cfg.plucker_lines and len(ls_ids):
            # ship raw normalized Pluecker; the packed BA converts to orth
            # IN-TRACE (a host-side batched conversion costs a device
            # round trip per BA)
            lines_plucker = np.zeros((cap_ls, 6), dtype)
            lines_plucker[: len(ls_ids)] = mp.ls_w[ls_ids]
            line_valid[: len(ls_ids)] = True
        elif len(ls_ids):
            # endpoint mode: each line takes two 3-DoF slots of the point
            # table (levMarquardtOptimizationLBA :1429-1445 layout)
            sl = np.arange(len(ls_ids))
            points[ep_base + 2 * sl] = mp.ls_epw[ls_ids, 0]
            points[ep_base + 2 * sl + 1] = mp.ls_epw[ls_ids, 1]
            point_valid[ep_base + 2 * sl] = True
            point_valid[ep_base + 2 * sl + 1] = True

        # -- observation rows from the flat tables (vectorized) --
        tb = mp.pobs
        psel = (tb.valid[: tb.n] & (slot_of_kf[tb.kf[: tb.n]] >= 0)
                & (pslot[tb.lm[: tb.n]] >= 0))
        prows = np.where(psel)[0]
        if len(prows) > cap_pobs:
            log.warning("BA point-obs capacity exceeded: %d > %d rows "
                        "(dropping overflow; raise MapConfig.ba_pobs or "
                        "use the chunked GBA)", len(prows), cap_pobs)
            prows = prows[:cap_pobs]
        n = len(prows)
        cam_slots = slot_of_kf[tb.kf[prows]]
        p_cam = np.zeros(cap_pobs, np.int32)
        p_lm = np.zeros(cap_pobs, np.int32)
        p_uv = np.zeros((cap_pobs, 2), dtype)
        p_sig = np.ones(cap_pobs, dtype)
        p_val = np.zeros(cap_pobs, bool)
        p_cam[:n] = cam_slots
        p_lm[:n] = pslot[tb.lm[prows]]
        p_uv[:n] = kf_pt_uv[cam_slots, tb.fi[prows]]
        p_sig[:n] = kf_pt_sig[cam_slots, tb.fi[prows]]
        p_val[:n] = True

        tb = mp.lobs
        lsel = (tb.valid[: tb.n] & (slot_of_kf[tb.kf[: tb.n]] >= 0)
                & (lslot[tb.lm[: tb.n]] >= 0))
        lrows = np.where(lsel)[0]

        l_cam = np.zeros(cap_lobs, np.int32)
        l_lm = np.zeros(cap_lobs, np.int32)
        l_sobs = np.zeros((cap_lobs, 2), dtype)
        l_eobs = np.zeros((cap_lobs, 2), dtype)
        l_sig = np.ones(cap_lobs, dtype)
        l_val = np.zeros(cap_lobs, bool)
        p_lo = None
        p_is_line = None
        if cfg.plucker_lines:
            if len(lrows) > cap_lobs:
                log.warning("BA line-obs capacity exceeded: %d > %d rows",
                            len(lrows), cap_lobs)
                lrows = lrows[:cap_lobs]
            nl = len(lrows)
            cam_slots = slot_of_kf[tb.kf[lrows]]
            l_cam[:nl] = cam_slots
            l_lm[:nl] = lslot[tb.lm[lrows]]
            l_sobs[:nl] = kf_ls_sp[cam_slots, tb.fi[lrows]]
            l_eobs[:nl] = kf_ls_ep[cam_slots, tb.fi[lrows]]
            l_sig[:nl] = kf_ls_sig[cam_slots, tb.fi[lrows]]
            l_val[:nl] = True
        else:
            # endpoint mode: each line obs yields two rows of the point
            # table — projected endpoint to observed image line
            room = (cap_pobs - n) // 2
            if len(lrows) > room:
                log.warning("BA endpoint-line obs overflow: %d > %d",
                            len(lrows), room)
                lrows = lrows[:room]
            cam_slots = slot_of_kf[tb.kf[lrows]]
            sp = kf_ls_sp[cam_slots, tb.fi[lrows]]
            ep = kf_ls_ep[cam_slots, tb.fi[lrows]]
            lo = np.cross(np.concatenate([sp, np.ones_like(sp[:, :1])], 1),
                          np.concatenate([ep, np.ones_like(ep[:, :1])], 1))
            nrm = np.hypot(lo[:, 0], lo[:, 1])
            keep = nrm > 1e-9
            lrows = lrows[keep]
            lo = lo[keep] / nrm[keep, None]
            cam_slots = cam_slots[keep]
            m = len(lrows)
            p_lo = np.zeros((cap_pobs, 3), dtype)
            p_is_line = np.zeros(cap_pobs, bool)
            sl = lslot[tb.lm[lrows]]
            r0 = n + 2 * np.arange(m)
            for off in (0, 1):
                rr = r0 + off
                p_cam[rr] = cam_slots
                p_lm[rr] = ep_base + 2 * sl + off
                p_lo[rr] = lo
                p_is_line[rr] = True
                p_sig[rr] = kf_ls_sig[cam_slots, tb.fi[lrows]]
                p_val[rr] = True
            n += 2 * m

        # numpy-leaved problem: the local-BA hot path ships it as three
        # packed buffers (ba.pack_problem_np), GBA stacks chunks first
        prob = ba_mod.BAProblem(
            T_c_w=T, pose_fixed=pose_fixed, pose_valid=pose_valid,
            points=points, point_valid=point_valid,
            lines_orth=lines_orth, lines_scale=lines_scale,
            line_valid=line_valid,
            p_cam=p_cam, p_lm=p_lm, p_uv=p_uv, p_sigma2=p_sig,
            p_valid=p_val,
            l_cam=l_cam, l_lm=l_lm, l_sobs=l_sobs, l_eobs=l_eobs,
            l_sigma2=l_sig, l_valid=l_val,
            p_lo=p_lo, p_is_line=p_is_line,
        )
        meta = dict(local_ids=local_ids, pt_ids=pt_ids, ls_ids=ls_ids,
                    prows=prows, lrows=lrows, lines_plucker=lines_plucker,
                    plucker=cfg.plucker_lines, ep_base=ep_base)
        return prob, meta

    def _ba_landmark_ids(self, slotmask: np.ndarray, min_obs: int = 2):
        """Landmarks with >= min_obs observations among the selected KFs."""
        mp = self.map
        tb = mp.pobs
        sel = tb.valid[: tb.n] & slotmask[tb.kf[: tb.n]]
        cnt = np.bincount(tb.lm[: tb.n][sel], minlength=mp.n_pt)
        pt_ids = np.where(mp.pt_valid & (cnt >= min_obs))[0]
        tb = mp.lobs
        sel = tb.valid[: tb.n] & slotmask[tb.kf[: tb.n]]
        cnt = np.bincount(tb.lm[: tb.n][sel], minlength=mp.n_ls)
        ls_ids = np.where(mp.ls_valid & (cnt >= min_obs))[0]
        if not self.cfg.use_lines:
            ls_ids = ls_ids[:0]
        return pt_ids, ls_ids

    def build_local_ba(self):
        """Assemble the padded BAProblem over the local map."""
        cfg = self.cfg
        mp = self.map
        local = mp.local_kf_set()
        local_ids = [k.id for k in mp.keyframes if local[k.id]][-cfg.local_ba_kf:]
        slotmask = np.zeros(len(mp.keyframes), bool)
        slotmask[local_ids] = True
        pt_ids, ls_ids = self._ba_landmark_ids(slotmask)
        if len(pt_ids) > cfg.ba_points:
            log.warning("local BA point capacity exceeded: %d > %d "
                        "(keeping most recent)", len(pt_ids), cfg.ba_points)
            pt_ids = pt_ids[-cfg.ba_points:]
        if not cfg.plucker_lines:
            # endpoint mode: each line takes two 3-DoF point slots
            room = (cfg.ba_points - len(pt_ids)) // 2
            if len(ls_ids) > max(room, 0):
                log.warning("local BA line capacity exceeded: %d lines > %d "
                            "endpoint slots left of ba_points=%d (keeping "
                            "most recent)", len(ls_ids), max(room, 0),
                            cfg.ba_points)
            ls_ids = ls_ids[-max(room, 0):] if room > 0 else ls_ids[:0]
        elif len(ls_ids) > cfg.ba_lines:
            log.warning("local BA line capacity exceeded: %d > %d",
                        len(ls_ids), cfg.ba_lines)
            ls_ids = ls_ids[-cfg.ba_lines:]
        # bucket capacities to the ACTUAL problem size (powers of two, so
        # the jitted BA compiles O(log) shapes): a 600-landmark local map
        # padded to the 2048/8192 config maxima wastes 3-4x device time
        n_pobs = self._count_obs(mp.pobs, slotmask, mp.n_pt, pt_ids)
        n_lobs = self._count_obs(mp.lobs, slotmask, mp.n_ls, ls_ids)
        if cfg.plucker_lines:
            need_pts, need_pobs = len(pt_ids), n_pobs
            cap_ls = min(cfg.ba_lines, _pad_bucket(len(ls_ids), lo=64))
            cap_lobs = min(cfg.ba_lobs, _pad_bucket(n_lobs, lo=256))
        else:
            need_pts = len(pt_ids) + 2 * len(ls_ids)
            need_pobs = n_pobs + 2 * n_lobs
            cap_ls = min(cfg.ba_lines, _pad_bucket(len(ls_ids), lo=64))
            cap_lobs = min(cfg.ba_lobs, _pad_bucket(n_lobs, lo=256))
        cap_pts = min(cfg.ba_points, _pad_bucket(need_pts, lo=256))
        cap_pobs = min(cfg.ba_pobs, _pad_bucket(need_pobs, lo=1024))
        return self._assemble_problem(
            local_ids, pt_ids, ls_ids, cap_pts, cap_ls,
            cap_pobs, cap_lobs, fix_rule="local",
            cap_k=cfg.local_ba_kf)

    @staticmethod
    def _count_obs(table: _ObsTable, slotmask: np.ndarray, n_lm: int,
                   lm_ids: np.ndarray) -> int:
        """Observation rows a BA over (slotmask KFs, lm_ids) will carry."""
        sel = np.zeros(n_lm, bool)
        sel[lm_ids] = True
        return int((table.valid[: table.n] & slotmask[table.kf[: table.n]]
                    & sel[table.lm[: table.n]]).sum())

    @_locked
    def local_bundle_adjustment(self, defer: bool = False):
        """Run the two-round chi^2-gated BA and write back
        (:6119-6319).  Problem transport is packed: 3 uploads + 1 fetch
        instead of ~28 round trips (ba.pack_problem_np).

        ``defer=True`` dispatches the solve and postpones the fetch +
        write-back until ``flush_ba()`` (or the next keyframe's combined
        association fetch) — the threaded pipeline's analog of the
        reference's skip-write-back-while-inserting protocol
        (mapHandler.cpp:2160)."""
        if len(self.map.keyframes) < 2:
            return None
        self.flush_ba()  # at most one solve in flight
        prob, meta = self.build_local_ba()
        self.n_local_ba += 1
        f, i, b, lay = ba_mod.pack_problem_np(
            prob, lines_plucker=meta["lines_plucker"])
        out = self._ba_packed(jnp.asarray(f), jnp.asarray(i),
                              jnp.asarray(b), self.cam, self.ba_cfg, lay)
        meta["lines_scale"] = prob.lines_scale
        if defer:
            with self._ba_lock:
                self._ba_pending = (out, lay, meta)
            return None
        return self._finish_local_ba(out, lay, meta)

    def _pose_jump(self, local_ids, T_c_w_new) -> float:
        """Largest pose-translation change a BA write-back would apply."""
        mp = self.map
        old = np.stack([mp.keyframes[k].T_w_k[:3, 3] for k in local_ids])
        new = np.stack([np.linalg.inv(
            np.asarray(T_c_w_new[s], np.float64))[:3, 3]
            for s in range(len(local_ids))])
        d = np.linalg.norm(new - old, axis=1)
        return float(d.max()) if len(d) else 0.0

    def _finish_local_ba(self, out, lay, meta) -> LocalBAResult:
        (T, points, orth, p_active, l_active,
         cost) = ba_mod.unpack_result_np(out, lay)
        mp = self.map
        jump = self._pose_jump(meta["local_ids"], T)
        if self.cfg.lba_max_jump > 0 and (
                not np.isfinite(jump) or jump > self.cfg.lba_max_jump):
            log.warning("local BA discarded: max pose jump %.2f m exceeds "
                        "lba_max_jump=%.2f (solver divergence guard)",
                        jump, self.cfg.lba_max_jump)
            return LocalBAResult(T, points, p_active, l_active, cost)
        for sl, kfid in enumerate(meta["local_ids"]):
            mp.keyframes[kfid].T_w_k = np.linalg.inv(
                np.asarray(T[sl], np.float64))
        self._write_back_landmarks(points, orth, meta["lines_scale"],
                                   p_active, l_active, meta)
        return LocalBAResult(T, points, p_active, l_active, cost)

    @_locked
    def flush_ba(self):
        """Apply a deferred local-BA result, if one is in flight."""
        with self._ba_lock:
            pending, self._ba_pending = self._ba_pending, None
        if pending is not None:
            out, lay, meta = pending
            self._finish_local_ba(np.asarray(jax.device_get(out)), lay,
                                  meta)

    def _fetch_with_pending(self, out):
        """device_get ``out``, folding any deferred BA result into the
        SAME sync (one round trip instead of two)."""
        with self._ba_lock:
            pending, self._ba_pending = self._ba_pending, None
        if pending is not None:
            pout, lay, meta = pending
            pout, buf = jax.device_get((pout, out))
            self._finish_local_ba(np.asarray(pout), lay, meta)
            return np.asarray(buf)
        return np.asarray(jax.device_get(out))

    def _gba_chunk_caps(self):
        """Per-chunk landmark capacities with the endpoint-mode
        |points| + 2*|lines| <= ba_points invariant — ONE definition
        shared by the single-chip chunked GBA and the kf-block sharded
        GBA (clamping only the point cap could overflow the table when
        ba_lines > ba_points/4)."""
        cfg = self.cfg
        cap_p, cap_l = cfg.ba_points, cfg.ba_lines
        if not cfg.plucker_lines:
            cap_p_eff = max(cap_p - 2 * cap_l, cap_p // 2)
            cap_l_eff = max(1, min(cap_l, (cap_p - cap_p_eff) // 2))
        else:
            cap_p_eff, cap_l_eff = cap_p, cap_l
        return cap_p, cap_l, cap_p_eff, cap_l_eff

    @_locked
    def global_bundle_adjustment(self):
        """GBA over ALL keyframes and ALL landmarks, tiled over fixed-shape
        landmark chunks so nothing is silently truncated
        (globalBundleAdjustment :3022-3126; chunked Schur accumulation is
        the fixed-shape equivalent of its all-landmark normal equations)."""
        cfg = self.cfg
        mp = self.map
        if len(mp.keyframes) < 2:
            return None
        self.flush_ba()
        local_ids = [k.id for k in mp.keyframes if k.active]
        slotmask = np.zeros(len(mp.keyframes), bool)
        slotmask[local_ids] = True
        pt_ids, ls_ids = self._ba_landmark_ids(slotmask)

        cap_p, cap_l, cap_p_eff, cap_l_eff = self._gba_chunk_caps()
        n_chunks = max(1,
                       -(-len(pt_ids) // cap_p_eff) if len(pt_ids) else 1,
                       -(-len(ls_ids) // cap_l_eff) if len(ls_ids) else 1)
        probs, metas = [], []
        for c in range(n_chunks):
            pc = pt_ids[c * cap_p_eff: (c + 1) * cap_p_eff]
            lc = ls_ids[c * cap_l_eff: (c + 1) * cap_l_eff]
            prob, meta = self._assemble_problem(
                local_ids, pc, lc, cap_p, cap_l,
                cfg.ba_pobs, cfg.ba_lobs, fix_rule="kf0",
                cap_k=_pad_bucket(len(local_ids), lo=8))
            probs.append(prob)
            metas.append(meta)
        log.info("GBA: %d KFs, %d points + %d lines in %d chunk(s)",
                 len(local_ids), len(pt_ids), len(ls_ids), n_chunks)
        for c, (prob, meta) in enumerate(zip(probs, metas)):
            probs[c] = _orth_from_plucker_meta(prob, meta)
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *probs)
        # pose fields are shared, not chunked
        stacked = stacked._replace(
            T_c_w=probs[0].T_c_w, pose_fixed=probs[0].pose_fixed,
            pose_valid=probs[0].pose_valid)
        res = self._gba_jit(stacked, self.cam, self.ba_cfg)
        # write back: poses once, landmarks per chunk
        (T_c_w, points, orth, scale, p_active, l_active) = jax.device_get(
            (res.problem.T_c_w, res.problem.points, res.problem.lines_orth,
             res.problem.lines_scale, res.p_active, res.l_active))
        jump = self._pose_jump(local_ids, T_c_w)
        if self.cfg.gba_max_jump > 0 and (
                not np.isfinite(jump) or jump > self.cfg.gba_max_jump):
            log.warning("GBA discarded: max pose jump %.2f m exceeds "
                        "gba_max_jump=%.2f (solver divergence guard)",
                        jump, self.cfg.gba_max_jump)
            return res
        for s, kfid in enumerate(local_ids):
            mp.keyframes[kfid].T_w_k = np.linalg.inv(
                np.asarray(T_c_w[s], np.float64))
        for c, meta in enumerate(metas):
            self._write_back_landmarks(
                points[c], orth[c], scale[c], p_active[c], l_active[c], meta)
        return res

    def _write_back_landmarks(self, points, orth, scale, p_active, l_active,
                              meta):
        mp = self.map
        pt_ids, ls_ids = meta["pt_ids"], meta["ls_ids"]
        points = np.asarray(points)
        if len(pt_ids):
            mp.pt_w[pt_ids] = points[: len(pt_ids)]
        if meta.get("plucker", True):
            if len(ls_ids):
                nls = len(ls_ids)
                lines = np.asarray(orth)
                if lines.shape[-1] == 6:
                    # packed transport already returned ||d||=1 Pluecker
                    mp.ls_w[ls_ids] = lines[:nls]
                else:
                    Lws = np.asarray(_plucker_from_orth_batch(
                        jnp.asarray(lines[:nls]))
                    ) * np.asarray(scale[:nls])[:, None]
                    mp.ls_w[ls_ids] = _np_normalize_plucker(Lws)
                # snap the stored world endpoints onto the optimized line:
                # Map2KF association gates on projected ls_epw (the
                # reference projects its endpoint lists, :799-921), so
                # stale creation-time endpoints would diverge from the
                # BA-optimized landmark and starve line re-observations
                Lw = mp.ls_w[ls_ids]
                nvec, d = Lw[:, :3], Lw[:, 3:]
                p0 = np.cross(d, nvec)       # closest line point to origin
                ep = mp.ls_epw[ls_ids]       # (n, 2, 3)
                t = np.einsum("nkj,nj->nk", ep - p0[:, None], d)
                snapped = p0[:, None] + t[..., None] * d[:, None]
                ok = np.isfinite(snapped).all(axis=(1, 2))
                mp.ls_epw[ls_ids[ok]] = snapped[ok]
        elif len(ls_ids):
            # endpoint mode: optimized endpoints come back through the
            # point table; refresh the Pluecker form (n = sP x eP,
            # d = eP - sP, renormalized ||d||=1) for projection-based
            # matching
            ep_base = meta["ep_base"]
            sl = np.arange(len(ls_ids))
            sP = points[ep_base + 2 * sl].astype(np.float64)
            eP = points[ep_base + 2 * sl + 1].astype(np.float64)
            mp.ls_epw[ls_ids] = np.stack([sP, eP], axis=1)
            d = eP - sP
            nd = np.linalg.norm(d, axis=-1)
            ok = np.isfinite(nd) & (nd > 1e-9)
            Lw = np.concatenate([np.cross(sP, eP), d], 1)
            mp.ls_w[ls_ids[ok]] = Lw[ok] / nd[ok, None]
        # prune gated-out observations (:6154-6293) with covis decrements
        p_active = np.asarray(p_active)
        prows = meta["prows"]
        if meta.get("plucker", True):
            bad_p = prows[~p_active[: len(prows)]]
            l_active = np.asarray(l_active)
            lrows = meta["lrows"]
            bad_l = lrows[~l_active[: len(lrows)]]
        else:
            bad_p = prows[~p_active[: len(prows)]]
            lrows = meta["lrows"]
            m = len(lrows)
            pa = p_active[len(prows): len(prows) + 2 * m]
            ok_l = pa[0::2] & pa[1::2] if m else np.zeros(0, bool)
            bad_l = lrows[~ok_l]
        self._prune_obs(bad_p, points_table=True)
        self._prune_obs(bad_l, points_table=False)

    def _prune_obs(self, rows: np.ndarray, points_table: bool):
        """Remove observations by obs-table row, resetting the per-KF
        feature->landmark link (links batched per keyframe)."""
        mp = self.map
        tb = mp.pobs if points_table else mp.lobs
        rows = np.asarray(rows, np.int64)
        if len(rows):
            live = rows[tb.valid[rows]]
            for kfid in np.unique(tb.kf[live]).tolist():
                fis = tb.fi[live[tb.kf[live] == kfid]]
                if points_table:
                    mp.keyframes[kfid].pt_lm[fis] = -1
                else:
                    mp.keyframes[kfid].ls_lm[fis] = -1
        if points_table:
            mp.remove_point_obs_rows(rows)
        else:
            mp.remove_line_obs_rows(rows)

    # -- culling -----------------------------------------------------------

    @_locked
    def cull_landmarks(self):
        """removeBadMapLandmarks (:3732): kill non-local landmarks older
        than cull_age KFs with fewer than min_lm_obs observations."""
        mp = self.map
        newest = len(mp.keyframes) - 1
        dead = (mp.pt_valid & (newest - mp.pt_last_kf > self.cfg.cull_age)
                & (mp.pt_nobs < self.cfg.min_lm_obs))
        mp.pt_valid[dead] = False
        dead = (mp.ls_valid & (newest - mp.ls_last_kf > self.cfg.cull_age)
                & (mp.ls_nobs < self.cfg.min_lm_obs))
        mp.ls_valid[dead] = False

    def refresh_landmark_descriptors(self, max_obs: int = 24):
        """Median-descriptor election (mapFeatures.cpp
        updateAverageDescDir :52-140): each landmark's representative
        descriptor becomes the observation descriptor with minimal summed
        Hamming distance to the others.  Fully batched: one gather over
        the stacked per-KF descriptor tables + one padded pairwise
        popcount per modality, no per-landmark Python loops.  Election
        considers the newest ``max_obs`` observations per landmark (long
        tracks saturate well before that)."""
        mp = self.map
        for table, valid, nobs, lm_desc, attr in (
                (mp.pobs, mp.pt_valid, mp.pt_nobs, mp.pt_desc, "pt_desc"),
                (mp.lobs, mp.ls_valid, mp.ls_nobs, mp.ls_desc, "ls_desc")):
            lms = np.where(valid & (nobs >= 3))[0]
            if not len(lms):
                continue
            kf_desc = np.stack([getattr(kf, attr)
                                for kf in mp.keyframes])  # (K, N, 8)
            L = len(lms)
            M = min(max_obs, int(nobs[lms].max()))
            # newest M live rows per landmark, gathered from the sorted
            # index (insertion order within a landmark)
            order, lo, hi = table.group_slices(lms)
            cnt = np.minimum(hi - lo, M)
            starts = hi - cnt
            idx = starts[:, None] + np.arange(M)[None, :]
            idx = np.clip(idx, 0, max(len(order) - 1, 0))
            rows = order[idx] if len(order) else np.zeros((L, M), np.int64)
            descs = kf_desc[table.kf[rows], table.fi[rows]]  # (L, M, 8)
            x = np.bitwise_xor(descs[:, :, None], descs[:, None, :])
            D = np.bitwise_count(x).sum(-1).astype(np.int32)  # (L, M, M)
            pad = np.arange(M)[None] >= cnt[:, None]          # (L, M)
            D[pad[:, :, None] | pad[:, None, :]] = 0
            best = (D.sum(-1) + np.where(pad, 1 << 20, 0)).argmin(-1)
            lm_desc[lms] = descs[np.arange(L), best]

    @_locked
    def cull_redundant_keyframes(self, max_common: float = 0.9):
        """removeRedundantKFs (:3899-4047): deactivate keyframes whose
        tracked landmarks are >= max_common shared with other keyframes;
        their observations are dropped from the landmark tables (keyframe
        poses stay, flagged inactive, excluded from local maps and BA) and
        landmarks they anchored are rebased onto a surviving observer
        (drop_keyframe_obs).  KF0 and the two newest KFs are never culled.

        One table pass total: the active-observer count per landmark is
        built once and updated incrementally as KFs fall, and each KF's
        own rows come from a kf-sorted grouping — O(K*table) in r3,
        O(table log table + K*own) now (weak #4)."""
        mp = self.map
        k = len(mp.keyframes)
        removed = []
        active = np.asarray([r.active for r in mp.keyframes])
        tb = mp.pobs
        sel = tb.valid[: tb.n] & active[tb.kf[: tb.n]]
        cnt = np.bincount(tb.lm[: tb.n][sel], minlength=mp.n_pt)
        rsel = np.where(sel)[0]
        by_kf = rsel[np.argsort(tb.kf[rsel], kind="stable")]
        kf_sorted = tb.kf[by_kf]
        for kf in mp.keyframes[1:max(1, k - 2)]:
            if not kf.active:
                continue
            lm_ids = kf.pt_lm[(kf.pt_lm >= 0)]
            lm_ids = lm_ids[mp.pt_valid[lm_ids]]
            if len(lm_ids) < 10:
                continue
            a = np.searchsorted(kf_sorted, kf.id, "left")
            b = np.searchsorted(kf_sorted, kf.id, "right")
            own_lms = np.sort(tb.lm[by_kf[a:b]])
            # count of OTHER active observers = total minus own rows
            oc = (np.searchsorted(own_lms, lm_ids, "right")
                  - np.searchsorted(own_lms, lm_ids, "left"))
            shared = int(((cnt[lm_ids] - oc) >= 2).sum())
            if shared / len(lm_ids) >= max_common:
                kf.active = False
                active[kf.id] = False
                removed.append(kf.id)
                np.add.at(cnt, own_lms, -1)
                mp.drop_keyframe_obs(kf.id)
        return removed

    # -- trajectory export -------------------------------------------------

    @_locked
    def keyframe_trajectory(self, include_inactive: bool = True):
        self.flush_ba()
        return [kf.T_w_k for kf in self.map.keyframes
                if include_inactive or kf.active]
