"""Map checkpoint / resume — save and restore the whole MapStore.

The reference CANNOT save or load its map (SURVEY.md §5.4: no
checkpointing at all, only trajectory export at shutdown); this fills that
gap deliberately. The SoA layout makes it trivial: every array goes into
one compressed npz; the free-list and graph auxiliaries are reconstructed.
Localization-only mode against a loaded map matches
System::ActivateLocalizationMode semantics with persistence added.

The file is the JAX package's format. The port adds its keyframe-slot
state beside it (``kf_seq`` as an array, the creation count and the free
slots in the metadata), which the JAX package's loader ignores; a file
without them (saved by the JAX package, which never reuses a slot) gets
the state it implies: creation number = id, the erased slots below
``next_kf`` free in id order.
"""
from __future__ import annotations

import json

import numpy as np

from .map import MapConfig, MapStore

_ARRAYS = [
    "kf_valid", "kf_R", "kf_t", "kf_timestamp", "kf_frame_id", "kf_uv",
    "kf_desc", "kf_octave", "kf_angle", "kf_uvr", "kf_depth",
    "kf_kp_valid", "kf_mp", "covis", "kf_parent",
    "mp_valid", "mp_pos", "mp_normal", "mp_dmin", "mp_dmax", "mp_desc",
    "mp_obs_kf", "mp_obs_feat", "mp_nobs", "mp_visible", "mp_found",
    "mp_first_kf",
]


def save_map(store: MapStore, path: str):
    cfg = store.cfg
    meta = dict(max_keyframes=cfg.max_keyframes,
                max_map_points=cfg.max_map_points, max_kp=cfg.max_kp,
                max_obs=cfg.max_obs, covis_threshold=cfg.covis_threshold,
                next_kf=store.next_kf,
                n_kf_created=int(store.n_kf_created),
                kf_free=[int(k) for k in store.kf_free],
                loop_edges={str(k): sorted(int(x) for x in v)
                            for k, v in store.kf_loop_edges.items()})
    arrays = {name: getattr(store, name) for name in _ARRAYS}
    np.savez_compressed(path, __meta__=json.dumps(meta),
                        kf_seq=store.kf_seq, **arrays)


def restore_slots(store, kf_seq=None, n_created=None, kf_free=None):
    """Set a store's keyframe-slot state, or derive it from ``kf_valid``
    and ``next_kf`` when not given (a map from the JAX package)."""
    n = int(store.next_kf)
    if kf_seq is None:
        kf_seq = np.where(np.arange(len(store.kf_seq)) < n,
                          np.arange(len(store.kf_seq)), -1)
        n_created = n
        kf_free = [int(k) for k in np.nonzero(~store.kf_valid[:n])[0]
                   if k != 0]
    store.kf_seq[...] = kf_seq
    store.n_kf_created = int(n_created)
    store.kf_free = [int(k) for k in kf_free]


def load_map(path: str) -> MapStore:
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    cfg = MapConfig(max_keyframes=meta["max_keyframes"],
                    max_map_points=meta["max_map_points"],
                    max_kp=meta["max_kp"], max_obs=meta["max_obs"],
                    covis_threshold=meta["covis_threshold"])
    store = MapStore(cfg)
    for name in _ARRAYS:
        getattr(store, name)[...] = data[name]
    store.next_kf = int(meta["next_kf"])
    store.kf_loop_edges = {int(k): set(v)
                           for k, v in meta["loop_edges"].items()}
    store.mp_free = [int(i) for i in
                     np.nonzero(~store.mp_valid)[0][::-1]]
    if "kf_seq" in data.files:
        restore_slots(store, data["kf_seq"], meta["n_kf_created"],
                      meta["kf_free"])
    else:
        restore_slots(store)
    return store
